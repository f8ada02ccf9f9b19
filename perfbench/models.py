"""The weights and inputs of each configuration, made by the benchmark from
the seed, on the card, in a few large calls; and the program's objects
built over them.  The reference reads the same weights, never the
program's copies."""

from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


def _uniform_leaves(shapes: Dict[str, tuple], bounds: Dict[str, float],
                    g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Leaves drawn uniform in ``±bound`` from one call."""
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.rand(sum(sizes), generator=g, device=device)
    out, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        b = bounds[name]
        out[name] = (flat[at:at + n] * (2 * b) - b).reshape(shape)
        at += n
    return out


def pool_classifier_weights(cfg: Dict, seed: int,
                            device) -> Dict[str, torch.Tensor]:
    """The X3 pool classifier's leaves: torch's initial distributions
    (xavier-uniform in-projection, uniform ``±1/√E`` out-projection and
    head), biases uniform in ``±1/√E`` so that every bias path carries
    numbers, the query normal with standard deviation ``√(2/E)``."""
    E, C = cfg["embed_dim"], cfg["num_classes"]
    g = generator(seed, "weights", device)
    inv = 1.0 / math.sqrt(E)
    shapes = {"in_proj_weight": (3 * E, E), "out_proj_weight": (E, E),
              "in_proj_bias": (3 * E,), "out_proj_bias": (E,),
              "head_w": (E, C), "head_b": (C,)}
    bounds = {k: inv for k in shapes}
    bounds["in_proj_weight"] = math.sqrt(6.0 / (4 * E))
    w = _uniform_leaves(shapes, bounds, g, device)
    w["query"] = torch.randn((1, 1, E), generator=g, device=device) \
        * math.sqrt(2.0 / E)
    return w


def pool_classifier_params(cfg: Dict, weights: Dict[str, torch.Tensor]):
    """The program's ``{'pool', 'query', 'head'}`` parameters holding
    copies of ``weights``."""
    from aecf_tpu_torch.train import init_pool_classifier_params

    dev = weights["query"].device
    params = init_pool_classifier_params(
        torch.Generator(device=dev), cfg["embed_dim"], cfg["num_classes"],
        device=dev)
    with torch.no_grad():
        pool = params["pool"]
        for name in ("in_proj_weight", "out_proj_weight", "in_proj_bias",
                     "out_proj_bias"):
            getattr(pool, name).copy_(weights[name])
        params["query"].copy_(weights["query"])
        params["head"]["w"].copy_(weights["head_w"])
        params["head"]["b"].copy_(weights["head_b"])
    return params


def vision_language_weights(cfg: Dict, seed: int,
                            device) -> Dict[str, torch.Tensor]:
    """The vision-language model's state: every weight and bias uniform in
    ``±1/√fan_in`` (xavier-uniform for the in-projection), the query
    normal with standard deviation ``√(2/E)``."""
    I, T, E, C = (cfg["img_dim"], cfg["txt_dim"], cfg["hidden_dim"],
                  cfg["num_classes"])
    g = generator(seed, "weights", device)
    shapes = {"img_proj.weight": (E, I), "img_proj.bias": (E,),
              "txt_proj.weight": (E, T), "txt_proj.bias": (E,),
              "pool.in_proj_weight": (3 * E, E), "pool.in_proj_bias": (3 * E,),
              "pool.out_proj_weight": (E, E), "pool.out_proj_bias": (E,),
              "classifier.weight": (C, E), "classifier.bias": (C,)}
    fan_in = {"img_proj": I, "txt_proj": T, "pool": E, "classifier": E}
    bounds = {k: 1.0 / math.sqrt(fan_in[k.split(".")[0]]) for k in shapes}
    bounds["pool.in_proj_weight"] = math.sqrt(6.0 / (4 * E))
    w = _uniform_leaves(shapes, bounds, g, device)
    w["fusion_query"] = torch.randn((1, 1, E), generator=g, device=device) \
        * math.sqrt(2.0 / E)
    return w


def vision_language_model(cfg: Dict, weights: Dict[str, torch.Tensor]):
    """The program's ``VisionLanguageModel`` in eval mode holding copies of
    ``weights``."""
    from aecf_tpu_torch.models import VisionLanguageModel

    dev = weights["fusion_query"].device
    model = VisionLanguageModel(
        cfg["img_dim"], cfg["txt_dim"], cfg["hidden_dim"], cfg["num_classes"],
        mask_prob=cfg["base_mask_prob"], num_heads=cfg["num_heads"],
        entropy_target=cfg["entropy_target"], min_active=cfg["min_active"],
        generator=torch.Generator(device=dev), device=dev)
    model.load_state_dict({k: v.clone() for k, v in weights.items()},
                          strict=True)
    return model.eval()
