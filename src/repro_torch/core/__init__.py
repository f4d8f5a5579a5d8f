"""Pure tensor stages of the Hilbert forest (quantizer, sketches, curve, search)."""
