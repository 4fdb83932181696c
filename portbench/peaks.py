"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): the rates a roofline share is stated against. A card set
to a lower power limit (the result's ``device.power``) reaches less."""

HBM_BYTES_PER_S = 3.35e12
F64_FLOP_PER_S = 67e12
