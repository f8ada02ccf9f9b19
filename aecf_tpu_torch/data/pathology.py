"""Radiology-report pathology mining (regex + negation detection).

Port of :mod:`aecf_tpu.data.pathology` (framework-free: a copy, so the
port imports nothing of the JAX package).  Behavioral re-implementation
of the reference miner (xrays/extract_xray_pathologies.py:13-85,
duplicated in show_multiple_pathology_examples.py:13-85) with the same
detection contract:

* a pathology counts as present if ANY whole-word mention of it is
  non-negated;
* a mention is negated when a negation cue *ends* before the mention starts
  within the context window (100 chars back / 50 chars forward of the
  mention) and within 50 chars of it;
* the 14 negation cues: no, not, absence of, without, rule out, ruled out,
  denies, negative for, free of, clear of, unlikely, exclude, excluded,
  normal.

Differences from the reference (deliberate, vectorizable design — this is
host-side preprocessing, so it is written for clarity and batch throughput,
not tensor parity):

* negation cues are compiled once into a single alternation regex instead of
  14 per-mention scans (O(cues·mentions) → O(text));
* each *mention* is checked against its own window, where the reference
  checks the window of the first occurrence of the pathology substring in
  the sliced context (a subtle bug for repeated mentions — we keep our exact
  behavior documented here and cover both in tests);
* works on plain dicts/lists — pandas is optional.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Mapping, Sequence

__all__ = [
    "NEGATION_PATTERNS",
    "check_pathology_presence",
    "find_single_pathology_cases",
    "load_xray_parquet",
]

NEGATION_PATTERNS = [
    r"\bno\b",
    r"\bnot\b",
    r"\babsence\s+of\b",
    r"\bwithout\b",
    r"\brule\s+out\b",
    r"\bruled\s+out\b",
    r"\bdenies\b",
    r"\bnegative\s+for\b",
    r"\bfree\s+of\b",
    r"\bclear\s+of\b",
    r"\bunlikely\b",
    r"\bexclude\b",
    r"\bexcluded\b",
    r"\bnormal\b",
]

_NEGATION_RE = re.compile("|".join(NEGATION_PATTERNS))

# Context window around a mention (reference :22-24).
_WINDOW_BACK = 100
_WINDOW_FWD = 50
# A negation only counts if it ends within this many chars before the
# mention (reference :43).
_NEGATION_REACH = 50


def check_pathology_presence(text: str, pathology: str) -> bool:
    """True if ``pathology`` has at least one non-negated whole-word mention."""
    text = text.lower()
    word = re.compile(r"\b" + re.escape(pathology.lower()) + r"\b")
    for match in word.finditer(text):
        window_start = max(0, match.start() - _WINDOW_BACK)
        window_end = min(len(text), match.end() + _WINDOW_FWD)
        context = text[window_start:window_end]
        mention_pos = match.start() - window_start
        negated = any(
            neg.end() <= mention_pos
            and (mention_pos - neg.end()) < _NEGATION_REACH
            for neg in _NEGATION_RE.finditer(context)
        )
        if not negated:
            return True
    return False


def find_single_pathology_cases(
    records: Iterable[Mapping],
    pathology_names: Sequence[str],
    *,
    verbose: bool = False,
) -> Dict[str, List[dict]]:
    """Group records by the *single* target pathology they mention.

    ``records`` yield mappings with ``findings``/``impression`` text fields
    and optionally ``image`` bytes.  A record is kept only when exactly one
    of ``pathology_names`` is positively mentioned (reference :55-85).
    Accepts a pandas DataFrame too (iterated via ``.iterrows()``).
    """
    if hasattr(records, "iterrows"):  # pandas DataFrame duck-typing
        records = (row for _, row in records.iterrows())

    out: Dict[str, List[dict]] = {p: [] for p in pathology_names}
    for idx, row in enumerate(records):
        if verbose and idx % 1000 == 0:
            print(f"  processed {idx} cases...")
        text = f"{row['findings']} {row['impression']}".lower()
        present = [
            p for p in pathology_names if check_pathology_presence(text, p)
        ]
        if len(present) == 1:
            out[present[0]].append(
                {
                    "index": idx,
                    "image_data": row.get("image")
                    if hasattr(row, "get")
                    else row["image"] if "image" in row else None,
                    "findings": row["findings"],
                    "impression": row["impression"],
                    "text": text,
                }
            )
    return out


def load_xray_parquet(path: str = "xray.parquet"):
    """Load the X-ray report parquet (columns: image, findings, impression).

    Requires pandas+pyarrow; the dataset itself is not distributed with the
    reference snapshot (.MISSING_LARGE_BLOBS) — use
    :mod:`aecf_tpu_torch.data.synthetic` when it is absent.
    """
    import pandas as pd

    return pd.read_parquet(path)
