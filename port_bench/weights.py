"""The weights both sides run, made by the benchmark from the seed.

The JAX package's ``fast_init`` rule: biases 0, normalisation scales 1,
every other tensor N(0, 0.02); the positional conv's ``weight_g`` is
‖weight_v‖ over its first two axes, so its effective weight is the drawn
``weight_v``. Drawn on the device from one ``torch.Generator`` seeded
with the run's seed, in one call over every drawn tensor in sorted name
order, as float32 (the type the program keeps its parameters in, in both
compute dtypes).
"""

from __future__ import annotations

from typing import Dict

import torch

from port_bench.reference.said import SAiD


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        shapes = SAiD(cfg)
    norms = shapes.norm_weight_names()
    sd = shapes.state_dict()
    drawn = [n for n in sorted(sd) if not n.endswith("bias") and n not in norms and not n.endswith(".weight_g")]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sd[n].numel() for n in drawn), generator=gen, device=device) * 0.02
    out = {}
    for name, part in zip(drawn, flat.split([sd[n].numel() for n in drawn])):
        out[name] = part.reshape(sd[name].shape)
    for name, t in sd.items():
        if name.endswith("bias"):
            out[name] = torch.zeros(t.shape, device=device)
        elif name in norms:
            out[name] = torch.ones(t.shape, device=device)
    for name in [n for n in sd if n.endswith(".weight_g")]:
        v = out[name[: -len("weight_g")] + "weight_v"]
        out[name] = v.norm(dim=(0, 1), keepdim=True)
    return {n: out[n] for n in sd}


def reference_model(cfg: dict, weights: Dict[str, torch.Tensor], device) -> SAiD:
    """The plain SAiD holding a copy of ``weights``, in eval mode."""
    with torch.device(device):
        model = SAiD(cfg)
    model.load_state_dict(weights, strict=True)
    return model.eval()
