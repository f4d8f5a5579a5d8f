"""repro_torch.models — the model zoo (``repro.models``): the config
dataclasses, the layers, the MoE FFN, the Mamba-2 SSD mixer and
:class:`~repro_torch.models.model.Transformer` with prefill, ring-cache
and SSM-state decode and the training losses, for all ten configs: the
dense decoders (yi_34b, gemma3_1b, nemotron_4_340b, granite_3_8b), MoE
(mixtral_8x22b, granite_moe_1b), Mamba-2 (mamba2_780m), the hybrid of
attention, Mamba-2 and MoE (jamba_v01_52b), the encoder-decoder with
stub audio frames (whisper_small) and the decoder with stub patch
embeddings (llava_next_34b)."""

from repro_torch.models.model import (  # noqa: F401
    Transformer,
    chunked_lm_loss,
    init_params,
    lm_loss,
    train_loss,
)
