"""Per-card plan table: measured launch plans for the port's kernels.

Port of :mod:`aecf_tpu.kernels.tiles`.  The JAX package's table makes its
TPU-measured batch tiles portable across TPU generations; this one makes
the port's launch plans portable across NVIDIA cards.  The port's kernels
take no batch tile: what a card's SM count, registers and shared memory
move is the **plan** of each launch site (:mod:`._plan`):

* a GEMM chain (the step, the shared-query forward and backward, the
  per-row forward) takes, for each of its products, the column tile ``bn``
  (64 or 128) and the K splits of ``csrc/gemm_f32.cuh``; its value is a
  JSON object ``{product: [bn, splits]}``;
* a streamed kernel takes its persistent grid's blocks an SM; its value is
  ``{"blocks_per_sm": n}``.

A product the value does not name keeps its default, the plan the chain
picks itself (``gemm_plan`` from the card's SM count; the streamed grids'
occupancy), which is what every launch takes with no env and no table.

Resolution order inside ``_plan._pick_plan`` (JAX's ``_pick_tile``):

1. ``AECF_TORCH_FWD_PLAN`` / ``AECF_TORCH_BWD_PLAN`` /
   ``AECF_TORCH_STEP_PLAN`` — a value as above, honoured verbatim for
   every forward / backward / step site that has the products it names; a
   malformed value, or a product no site of the kind has, raises
   ``ValueError``.  JAX's ``AECF_FWD_TB`` / ``AECF_BWD_TB`` /
   ``AECF_STEP_TB`` integers are never read here, nor are these names read
   by JAX: the tests run both packages in one process.
2. The table entry for the site key — verbatim as well.
3. The default.

A plan a product cannot take (``bn = 128`` on an n-major weight, splits on
the quadratic loss's product, more splits than k-stages, more blocks an SM
than run at once) raises at the launch site; it never quietly becomes the
default.

Table location: ``$AECF_TORCH_TILE_TABLE`` if set, else
``~/.cache/aecf_tpu_torch/tiles_<card>.json`` (the card's
``torch.cuda.get_device_name()`` slugged, e.g. ``nvidia-h100-80gb-hbm3``;
the cache root moves with ``$XDG_CACHE_HOME``).  A missing file is an empty
table; entries that fail validation — a JAX batch tile (a bare integer)
among them — are dropped with a warning.

Site keys are JAX's (:func:`site_key`, the same six sites and format), so
an entry applies to one card model, one config and one kv dtype.  Two
differences of meaning: the streamed backward (``bwd_streamed``) resolves
its grid from the ``kv=float32`` key whatever the call's dtype — its grid
sets the order of the batch sums, and an int8 or bf16 call must sum in the
f32 call's order (``csrc/stream_bwd.cu``); and JAX's rule that
``AECF_STEP_TB`` equal ``AECF_FWD_TB`` (a mask drawn per tile) has no
counterpart: the port's draws are keyed by the global (row, modality)
index, so no plan changes a mask.
"""

from __future__ import annotations

import json
import os
import re
import threading
import warnings
from typing import Dict, List, Optional, Tuple, Union

__all__ = [
    "site_key",
    "table_path",
    "load_table",
    "lookup",
    "set_table",
    "update_table",
    "start_recording",
    "stop_recording",
    "record",
]

# A value: {product: (bn, splits)} or {"blocks_per_sm": n}.
Plan = Dict[str, Union[Tuple[int, int], int]]

ENV_TABLE = "AECF_TORCH_TILE_TABLE"
GRID = "blocks_per_sm"
_BNS = (64, 128)

_lock = threading.Lock()
# None = not loaded yet; dict = loaded (possibly empty).  set_table()
# installs an explicit in-process table that shadows the file.
_file_cache: Optional[Dict[str, Plan]] = None
_explicit: Optional[Dict[str, Plan]] = None
_recording: Optional[List[Tuple[str, Plan, str]]] = None
# Bumped whenever what lookup() answers may change: the plan caches key on it.
_generation = 0


def site_key(
    site: str,
    *,
    M: int,
    E: int,
    H: int,
    kv_dtype: str,
    want_dkv: Optional[bool] = None,
) -> str:
    """Canonical table key for one launch site (the JAX package's format).

    ``want_dkv`` applies to backward sites only (whether the d_kv output
    is written); forward sites leave it ``None`` and the field is omitted.
    """
    key = f"{site}:M={M}:E={E}:H={H}:kv={kv_dtype}"
    if want_dkv is not None:
        key += f":dkv={int(want_dkv)}"
    return key


def _device_slug() -> str:
    """Slug of the current card's name, e.g. 'NVIDIA H100 80GB HBM3' ->
    'nvidia-h100-80gb-hbm3'; 'unknown' without a card."""
    try:
        import torch

        name = (torch.cuda.get_device_name() if torch.cuda.is_available()
                else "unknown")
    except Exception:  # noqa: BLE001 — never let table IO break a launch
        name = "unknown"
    return re.sub(r"[^a-z0-9]+", "-", name.lower()).strip("-") or "unknown"


def table_path() -> str:
    """Path the table is read from / written to.

    ``$AECF_TORCH_TILE_TABLE`` overrides; default is a per-card file under
    ``~/.cache/aecf_tpu_torch/`` (override the cache root with
    ``$XDG_CACHE_HOME``).
    """
    env = os.environ.get(ENV_TABLE)
    if env:
        return env
    cache_root = os.environ.get(
        "XDG_CACHE_HOME", os.path.join(os.path.expanduser("~"), ".cache")
    )
    return os.path.join(
        cache_root, "aecf_tpu_torch", f"tiles_{_device_slug()}.json"
    )


def _is_int(x: object) -> bool:
    return isinstance(x, int) and not isinstance(x, bool)


def check_value(value: object) -> Plan:
    """A plan value in its normal form (pairs as tuples), or ``ValueError``:
    a non-empty object of ``product: [bn, splits]`` (bn 64 or 128, splits
    >= 1), or ``{"blocks_per_sm": n}`` (n >= 1)."""
    if not isinstance(value, dict) or not value:
        raise ValueError(f"plan {value!r} is not a non-empty JSON object")
    if GRID in value:
        n = value[GRID]
        if len(value) != 1 or not _is_int(n) or n < 1:
            raise ValueError(
                f"plan {value!r}: a streamed plan is {{{GRID!r}: n}}, n >= 1"
            )
        return {GRID: n}
    plan: Plan = {}
    for name, pair in value.items():
        if (not isinstance(name, str) or not isinstance(pair, (list, tuple))
                or len(pair) != 2 or not all(map(_is_int, pair))
                or pair[0] not in _BNS or pair[1] < 1):
            raise ValueError(
                f"plan {value!r}: product {name!r} needs [bn, splits], bn "
                f"in {_BNS}, splits >= 1"
            )
        plan[name] = (pair[0], pair[1])
    return plan


def _validate(raw: object, path: str) -> Dict[str, Plan]:
    if not isinstance(raw, dict):
        warnings.warn(
            f"tile table {path!r} is not a JSON object; ignoring it",
            stacklevel=3,
        )
        return {}
    table: Dict[str, Plan] = {}
    bad = []
    for k, v in raw.items():
        try:
            if not isinstance(k, str):
                raise ValueError(k)
            table[k] = check_value(v)
        except ValueError:
            bad.append(k)
    if bad:
        warnings.warn(
            f"tile table {path!r}: dropping invalid entries {bad!r} (values "
            f"must be {{product: [bn, splits]}} or {{{GRID!r}: n}})",
            stacklevel=3,
        )
    return table


def load_table(path: Optional[str] = None) -> Dict[str, Plan]:
    """Load and validate a plan table; a missing file is an empty table."""
    path = path or table_path()
    try:
        with open(path) as f:
            raw = json.load(f)
    except FileNotFoundError:
        return {}
    except (OSError, json.JSONDecodeError) as e:
        warnings.warn(
            f"tile table {path!r} unreadable ({e}); ignoring it",
            stacklevel=2,
        )
        return {}
    return _validate(raw, path)


def set_table(table: Optional[Dict[str, Plan]]) -> None:
    """Install an explicit in-process table (shadows the file), or ``None``
    to fall back to the file.  Also drops the cached file table so the next
    lookup re-reads ``table_path()`` — tests and long-lived processes use
    this to pick up a freshly written table.  Values are validated
    (``ValueError``)."""
    global _explicit, _file_cache, _generation
    checked = (None if table is None
               else {k: check_value(v) for k, v in table.items()})
    with _lock:
        _explicit = checked
        _file_cache = None
        _generation += 1


def lookup(key: str) -> Optional[Plan]:
    """Measured plan for ``key``, or ``None`` (no entry → the default).

    The file table is read once per process; call :func:`set_table` (even
    ``set_table(None)``) to invalidate.
    """
    global _file_cache
    with _lock:
        if _explicit is not None:
            return _explicit.get(key)
        if _file_cache is None:
            _file_cache = load_table()
        return _file_cache.get(key)


def generation() -> int:
    """A count that changes whenever :func:`lookup` may answer otherwise."""
    return _generation


def update_table(
    entries: Dict[str, Optional[Plan]], path: Optional[str] = None
) -> str:
    """Merge ``entries`` into the table at ``path`` (atomic tmp+rename);
    returns the path written.  Existing keys are overwritten; a value of
    ``None`` or ``{}`` deletes the key; an invalid value raises
    ``ValueError``."""
    global _file_cache, _generation
    path = path or table_path()
    table = load_table(path)
    for k, v in entries.items():
        if not v:
            table.pop(k, None)
        else:
            table[k] = check_value(v)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(table, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    with _lock:
        _file_cache = None
        _generation += 1
    return path


def start_recording() -> None:
    """Begin recording (site_key, plan, source) triples from every
    subsequent launch-site resolution — the tuner runs a chunk once to
    discover which sites a config exercises."""
    global _recording
    with _lock:
        _recording = []


def stop_recording() -> List[Tuple[str, Plan, str]]:
    """End recording and return the log.  ``source`` is one of ``"env"`` /
    ``"table"`` / ``"default"``; ``plan`` is the whole plan the site runs,
    its default products filled in."""
    global _recording
    with _lock:
        log, _recording = _recording or [], None
    return log


def record(key: Optional[str], plan: Plan, source: str) -> None:
    """Internal: log one pick when recording is active (no-op otherwise)."""
    if _recording is None or key is None:
        return
    with _lock:
        if _recording is not None:
            _recording.append((key, plan, source))
