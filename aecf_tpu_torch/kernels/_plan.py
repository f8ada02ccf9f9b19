"""Launch plans of the port's kernels: the knob :mod:`.tiles` records.

Every GEMM chain (``csrc/train_step.cu``, ``shared_query_fwd.cu``,
``shared_query_bwd.cu``, ``fused_pool_fwd.cu``) takes from its caller, for
each of its products, a ``GemmTile`` — the column tile ``bn`` (64, or 128
with a k-major weight) and the K splits; ``{0, 0}`` runs the chain's own
default, ``gemm_plan`` in ``csrc/gemm_f32.cuh``.  The streamed kernels
(``stream_mix.cu``, ``stream_bwd.cu``) take their persistent grid's
blocks an SM, 0 for the occupancy limit.

:func:`_pick_plan` and :func:`_pick_grid` — the counterparts of the JAX
package's ``_pick_tile`` (``aecf_tpu/kernels/shared_query.py``) — resolve a
site's plan (env > table > default, :mod:`.tiles`), record it, and return
what the C call takes.  A default product goes to C as ``{0, 0}``, so a
launch with no env and no table is the one the chain picks itself; the
Python copy of ``gemm_plan`` here gives the default's value for the
record and the tuner, and ``chip_smoke.py`` holds it to the C one at every
checked product (``aecf_*_plans``).  The wrappers resolve before their
CPU/CUDA branch, so the CPU tests see every site; the plain versions
ignore the plan.
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

from . import tiles

__all__ = [
    "ENV",
    "GemmTile",
    "Product",
    "candidates",
    "fused_fwd_products",
    "gemm_plan",
    "plan_of",
    "sm_count",
    "sq_bwd_products",
    "sq_fwd_products",
    "step_products",
]

BM, BK = 128, 32  # gemm_f32.cuh: the block tile's rows, a stage's k-depth
H100_SXM_SMS = 132  # the SM count a CPU tensor's default plan is sized by

# The env knob of each kind of site, and the products its sites have.
ENV = {"fwd": "AECF_TORCH_FWD_PLAN", "bwd": "AECF_TORCH_BWD_PLAN",
       "step": "AECF_TORCH_STEP_PLAN"}
_KIND_PRODUCTS = {
    "fwd": {"out", "ctx", "qp", "u", tiles.GRID},
    "bwd": {"d_mix", "g", tiles.GRID},
    "step": {"out", "d_mix", "g", "dw_head"},
}


class GemmTile(ctypes.Structure):
    """``GemmTile`` of ``csrc/gemm_f32.cuh``: a product's plan."""

    _fields_ = [("bn", ctypes.c_int), ("splits", ctypes.c_int)]


class Product(NamedTuple):
    """One product of a chain (``gemm::Product``): its name in a plan, its
    shape, and what its layout and epilogue allow."""

    name: str
    rows: int
    N: int
    K: int
    groups: int
    w_kmajor: bool
    may_split: bool


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def step_products(B: int, E: int, C: int) -> Tuple[Product, ...]:
    """``train_step.cu``: out (split only with the head), d_mix, G and,
    with the head, dW_head."""
    q = (Product("out", B, E, E, 1, False, C > 0),
         Product("d_mix", B, E, E, 1, True, True),
         Product("g", E, E, B, 1, True, True))
    return q + ((Product("dw_head", E, C, B, 1, True, True),) if C else ())


@functools.lru_cache(maxsize=256)
def sq_fwd_products(B: int, E: int, H: int) -> Tuple[Product, ...]:
    """``shared_query_fwd.cu``: the out GEMM, after the grouped context
    GEMM at H > 1."""
    out = Product("out", B, E, E, 1, False, True)
    return (out,) if H == 1 else (
        Product("ctx", B, E // H, E, H, False, True), out)


@functools.lru_cache(maxsize=256)
def sq_bwd_products(B: int, E: int) -> Tuple[Product, ...]:
    """``shared_query_bwd.cu``: d_mix, then G."""
    return (Product("d_mix", B, E, E, 1, True, True),
            Product("g", E, E, B, 1, True, True))


@functools.lru_cache(maxsize=256)
def fused_fwd_products(B: int, E: int, H: int,
                       qrows: int) -> Tuple[Product, ...]:
    """``fused_pool_fwd.cu``: QP, U, CTX, out (``qrows`` 1 for a query of
    row stride 0, else B)."""
    Dh = E // H
    return (Product("qp", qrows, E, E, 1, False, True),
            Product("u", qrows, E, Dh, H, True, True),
            Product("ctx", B, Dh, E, H, False, True),
            Product("out", B, E, E, 1, False, True))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """SMs of ``device`` (the C chains' ``sm_count()``); the H100 SXM's 132
    for a CPU tensor, whose plain versions take no plan."""
    import torch

    if not isinstance(device, torch.device):
        device = torch.device(device)
    if device.type != "cuda":
        return H100_SXM_SMS
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def gemm_plan(q: Product, sms: int) -> Tuple[int, int]:
    """``gemm_plan`` of ``csrc/gemm_f32.cuh``: the default ``(bn, splits)``
    of a product on a card of ``sms`` SMs (the splits that run)."""
    mt = _cdiv(q.rows, BM)
    bn = (128 if q.w_kmajor and q.N > 64
          and mt * _cdiv(q.N, 128) * q.groups >= 2 * sms else 64)
    blocks = mt * _cdiv(q.N, bn) * q.groups
    splits = 1
    if q.may_split and blocks < sms:
        splits = max(1, min(2 * sms // blocks, q.K // (4 * BK)))
    return bn, _cdiv(q.K, _cdiv(_cdiv(q.K, splits), BK) * BK)


def plan_of(q: Product, bn: int, splits: int) -> Tuple[int, int, int]:
    """``plan_of`` of ``csrc/gemm_f32.cuh`` for a caller's plan: ``(bn,
    splits, k_per_split)`` as the product runs it, or ``ValueError`` where
    the chain refuses it."""
    if (not (bn == 64 or (bn == 128 and q.w_kmajor)) or splits < 1
            or (splits > 1 and not q.may_split) or splits > _cdiv(q.K, BK)):
        raise ValueError(
            f"product {q.name!r} ({q.rows}x{q.N}, K={q.K}, "
            f"{'k' if q.w_kmajor else 'n'}-major W, "
            f"{'' if q.may_split else 'no '}split) cannot take bn={bn}, "
            f"splits={splits}: bn is 64, or 128 with a k-major W; splits "
            f"1 .. ceil(K / {BK}), above 1 only where the epilogue allows"
        )
    k_per_split = _cdiv(_cdiv(q.K, splits), BK) * BK
    return bn, _cdiv(q.K, k_per_split), k_per_split


def candidates(q: Product, bn: int, splits: int) -> Sequence[Tuple[int, int]]:
    """The tuner's candidates around a product's plan ``(bn, splits)``:
    bn in {64, 128 where the product takes it and N > 64}, splits in {1,
    s/2, s, 2s, 4s} clamped to 1 .. ceil(K / 32) (1 where the epilogue
    forbids splits); sorted, the plan itself among them."""
    bns = [64] + ([128] if q.w_kmajor and q.N > 64 else [])
    top = _cdiv(q.K, BK) if q.may_split else 1
    ss = {max(1, min(s, top)) for s in (1, splits // 2, splits, 2 * splits,
                                        4 * splits)}
    return sorted({(b, s) for b in bns for s in ss} | {(bn, splits)})


def _kind(site: str) -> str:
    return site.split("_", 1)[0]


def _env(kind: str) -> Optional[tiles.Plan]:
    """The kind's env knob, checked (``ValueError`` when malformed or naming
    a product no site of the kind has)."""
    name = ENV[kind]
    raw = os.environ.get(name)
    if not raw:
        return None
    try:
        plan = tiles.check_value(json.loads(raw))
    except (ValueError, TypeError) as e:  # JSONDecodeError is a ValueError
        raise ValueError(f"{name}={raw!r}: {e}") from None
    unknown = set(plan) - _KIND_PRODUCTS[kind]
    if unknown:
        raise ValueError(
            f"{name}={raw!r}: no {kind} site has products {sorted(unknown)} "
            f"(they are {sorted(_KIND_PRODUCTS[kind])})"
        )
    return plan


_cache: Dict[tuple, tuple] = {}


def _resolve(site: str, key: str, names: Sequence[str]):
    """The site's asked-for entries and their source: env > table >
    default.  ``names`` are the site's products; only the ones an env or
    table value names are asked for."""
    env = _env(_kind(site))
    entry = tiles.lookup(key)
    asked = {n: entry[n] for n in names if entry and n in entry}
    source = "table" if asked else "default"
    from_env = {n: env[n] for n in names if env and n in env}
    if from_env:
        asked.update(from_env)
        source = "env"
    return asked, source


def _pick_plan(site: str, products: Sequence[Product], *, M: int, E: int,
               H: int, kv_dtype: str, want_dkv: Optional[bool] = None,
               device, slots: int = 0, record: bool = True):
    """A GEMM chain's plan at one launch: the ``GemmTile`` array for its C
    call, one a product in launch order (``{0, 0}`` for a default product;
    ``slots`` entries at least, the rest zeros).  Resolved env > table >
    default (:mod:`.tiles`), checked (``ValueError`` for a plan a product
    cannot take) and recorded as
    ``(site key, {product: (bn, splits)}, source)`` with the defaults
    filled in.  ``.plan`` on the array holds that dict."""
    key = tiles.site_key(site, M=M, E=E, H=H, kv_dtype=kv_dtype,
                         want_dkv=want_dkv)
    sms = sm_count(device)
    memo = (key, products, sms, slots,
            os.environ.get(ENV[_kind(site)]), tiles.generation())
    hit = _cache.get(memo)
    if hit is None:
        asked, source = _resolve(site, key, [q.name for q in products])
        full = {}
        for q in products:
            if q.name in asked:
                plan_of(q, *asked[q.name])
                full[q.name] = asked[q.name]
            else:
                full[q.name] = gemm_plan(q, sms)
        arr = (GemmTile * max(slots, len(products)))(
            *(asked.get(q.name, (0, 0)) for q in products))
        arr.plan = full
        if len(_cache) > 4096:
            _cache.clear()
        hit = _cache[memo] = (arr, source)
    arr, source = hit
    if record:
        tiles.record(key, dict(arr.plan), source)
    return arr


def _pick_grid(site: str, *, M: int, E: int, H: int, kv_dtype: str,
               want_dkv: Optional[bool] = None, record: bool = True) -> int:
    """A streamed kernel's blocks an SM at one launch (0: the occupancy
    limit, the default), resolved and recorded as :func:`_pick_plan`
    does; the C call refuses more than its occupancy."""
    key = tiles.site_key(site, M=M, E=E, H=H, kv_dtype=kv_dtype,
                         want_dkv=want_dkv)
    asked, source = _resolve(site, key, [tiles.GRID])
    n = asked.get(tiles.GRID, 0)
    if record:
        tiles.record(key, {tiles.GRID: n}, source)
    return n


def dtype_name(dtype) -> str:
    """A torch dtype as the site keys spell it: ``float32``, ``bfloat16``,
    ``int8``."""
    return str(dtype).rsplit(".", 1)[-1]
