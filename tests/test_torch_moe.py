"""Port parity: ``repro_torch.models.moe`` against ``repro.models.moe``.

The same numpy-seeded weights (``repro``'s ``moe_init``) and inputs go
through both packages' ``moe_forward`` on the CPU, in fp32:

* output and aux within rtol 1e-5 / atol 1e-6, at a capacity that drops
  tokens, at a drop-free one, and with exact router ties (the lower expert
  first, as ``lax.top_k``);
* the MoE decoders (granite_moe_1b, mixtral_8x22b smoke configs): the
  module's parameter count is ``cfg.param_count()``, its leaves are
  ``repro``'s, and prefill then decode equals the forward pass at the
  configs' drop-free capacity.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.sharding import ShardingRules
from repro_torch import configs as tconfigs
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_jax

RULES = ShardingRules()
RTOL, ATOL = 1e-5, 1e-6
B, S = 2, 32
MOE_ARCHS = ("granite_moe_1b", "mixtral_8x22b")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The models here are small and the suite's workers share the cores:
    one intra-op thread (with eight, on an 8-core CPU under six workers,
    tests here ran up to 40x slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(arch, **kw):
    kw.setdefault("compute_dtype", "float32")
    return (dataclasses.replace(jconfigs.get_config(arch, smoke=True), **kw),
            dataclasses.replace(tconfigs.get_config(arch, smoke=True), **kw))


def moe_pair(jcfg, tcfg, seed=0):
    """(repro's moe_init leaves, the port's MoE on the same weights)."""
    jp = jax.tree.map(np.asarray, jmoe.moe_init(jcfg, jax.random.key(seed)))
    p = tmoe.MoE(tcfg, device="cpu")
    p.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jp.items()})
    return jp, p


def both(jcfg, tcfg, jp, p, x):
    jout, jaux = jax.jit(lambda p, x: jmoe.moe_forward(jcfg, p, x, RULES))(jp, x)
    with torch.no_grad():
        tout, taux = tmoe.moe_forward(tcfg, p, torch.from_numpy(x))
    return (np.asarray(jout), float(jaux)), (tout.numpy(), float(taux))


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor", [0.5, 2.0], ids=["drops", "drop_free"])
def test_moe_forward_and_aux_match_repro(arch, capacity_factor):
    jcfg, tcfg = cfgs(arch, capacity_factor=capacity_factor)
    cap = tmoe.expert_capacity(tcfg, S)
    assert cap == jmoe.expert_capacity(jcfg, S)
    drops = cap * jcfg.n_experts < S * jcfg.topk_experts
    assert drops == (capacity_factor < 1)  # the first case really drops tokens
    jp, p = moe_pair(jcfg, tcfg)
    x = np.random.default_rng(0).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    (jout, jaux), (tout, taux) = both(jcfg, tcfg, jp, p, x)
    np.testing.assert_allclose(tout, jout, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(taux, jaux, rtol=RTOL)


def test_router_ties_pick_the_lower_expert_first():
    """Experts 2k and 2k+1 share a router column, so every token's
    probabilities tie in pairs; their FFN weights differ, so picking the
    higher expert of a tied pair would change the output."""
    jcfg, tcfg = cfgs("granite_moe_1b", topk_experts=3)
    jp, _ = moe_pair(jcfg, tcfg, seed=1)
    jp = dict(jp, router=np.repeat(jp["router"][:, ::2], 2, axis=1))
    p = tmoe.MoE(tcfg, device="cpu")
    p.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jp.items()})
    x = np.random.default_rng(1).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    _, eidx = jax.lax.top_k(probs, 3)
    assert (np.asarray(eidx)[..., 0] % 2 == 0).all()  # ties are real
    (jout, jaux), (tout, taux) = both(jcfg, tcfg, jp, p, x)
    np.testing.assert_allclose(tout, jout, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(taux, jaux, rtol=RTOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_layout_and_param_count(arch):
    jcfg, tcfg = cfgs(arch)
    tm = tmodel.init_params(tcfg, 0, device="cpu")
    assert sum(p.numel() for p in tm.parameters()) == tcfg.param_count()
    jp = jax.tree.map(np.asarray, jmodel.init_params(jcfg, jax.random.key(0)))
    assert set(params_from_jax(tcfg, jp)) == set(tm.state_dict())
    ffn = tm.layers[0].ffn
    d, f = tcfg.d_model, tcfg.d_ff
    assert ffn.w1.shape == (tcfg.n_experts, d, f) and ffn.w2.shape == (tcfg.n_experts, f, d)
    for w, scale in ((ffn.router, d), (ffn.w1, d), (ffn.w2, f), (ffn.w3, d)):
        assert abs(w.std().item() * np.sqrt(scale) - 1.0) < 0.1


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_then_decode_equals_forward_drop_free(arch):
    """At the smoke configs' drop-free capacity (E / k) a token's experts
    never overflow, so prefill + decode reproduce the forward pass."""
    _, tcfg = cfgs(arch)
    assert tcfg.capacity_factor == tcfg.n_experts / tcfg.topk_experts
    tm = tmodel.init_params(tcfg, 2, device="cpu")
    toks = np.random.default_rng(2).integers(0, tcfg.vocab_size, (B, S))
    full = tm(toks)
    s_pre = S - 6
    pre, caches = tm.prefill(toks[:, :s_pre])
    torch.testing.assert_close(pre, full[:, s_pre - 1], rtol=1e-4, atol=1e-5)
    caches = tm.pad_caches(caches, S)
    for t in range(s_pre, S):
        logits, caches = tm.decode_step(toks[:, t : t + 1], t, caches)
        torch.testing.assert_close(logits, full[:, t], rtol=1e-4, atol=1e-5)
