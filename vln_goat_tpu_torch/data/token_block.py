"""Token-block slicing for LM-style datasets (counterpart of
vln_goat_tpu/data/token_block.py): fairseq's token_block_utils_fast.pyx,
the one native component of the reference's vendored fairseq.

A numpy implementation, and the C++ one of the port's native library
(`native/csrc/goat_native.cpp` token_block_slices /
block_to_dataset_index), taken with `use_native=True` when the library is
available (`native.available()`, which builds it where g++ is present).
Break modes follow _get_slice_indices_fast:

- 'none':          fixed block_size windows over the flat token stream
- 'complete':      blocks of whole sentences, <= block_size tokens
- 'complete_doc':  like complete, but document_sep_len-sized sentences mark
                   document boundaries; only blocks with > 1 token are kept
- 'eos':           one block per sentence

The target size of block k is block_sizes[k] when block_multiple_max > 1
and block_sizes is given, else block_multiple_min * block_size.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .. import native


def token_block_slices(sizes, block_size: int, break_mode: str = "none",
                       document_sep_len: int = 1,
                       block_multiple_min: int = 1,
                       block_multiple_max: int = 1,
                       block_sizes: Optional[np.ndarray] = None,
                       use_native: bool = True) -> np.ndarray:
    """[n_blocks, 2] int64 (start, end) offsets into the flat token stream
    of sentences of lengths `sizes`."""
    sizes = np.asarray(sizes, np.int64)
    if use_native and native.available():
        return native.token_block_slices(
            sizes, block_size, break_mode, document_sep_len,
            block_multiple_min, block_multiple_max, block_sizes)
    total = int(sizes.sum())
    if break_mode in (None, "none"):
        length = -(-total // block_size)
        starts = np.arange(length, dtype=np.int64) * block_size
        ends = np.minimum(starts + block_size, total)
        return np.stack([starts, ends], axis=1)
    if break_mode == "eos":
        cum = np.cumsum(sizes)
        out = np.zeros((len(sizes), 2), np.int64)
        out[1:, 0] = cum[:-1]
        out[:, 1] = cum
        return out
    if break_mode not in ("complete", "complete_doc"):
        raise ValueError(f"invalid break_mode {break_mode}")

    def next_bs(counter):
        if block_multiple_max > 1 and block_sizes is not None:
            return int(block_sizes[counter])
        return block_multiple_min * block_size

    doc = break_mode == "complete_doc"
    counter = 0
    bs = next_bs(counter)
    out, tok, curr, i = [], 0, 0, 0
    while i < len(sizes):
        sep = doc and sizes[i] == document_sep_len
        if (curr + sizes[i] <= bs or curr == 0) and not sep:
            curr += int(sizes[i])
            i += 1
            continue
        if curr > int(doc):
            out.append((tok, tok + curr))
        tok += curr
        curr = 0
        counter += 1
        bs = next_bs(counter)
        if sep:
            tok += int(sizes[i])
            i += 1
    if curr > int(doc):
        out.append((tok, tok + curr))
    return np.asarray(out, np.int64).reshape(-1, 2)


def block_to_dataset_index(sizes, slices, use_native: bool = True
                           ) -> np.ndarray:
    """Map flat (start, end) slices to (start_ds_idx, start_offset,
    end_ds_idx) (_get_block_to_dataset_index_fast)."""
    sizes = np.asarray(sizes, np.int64)
    slices = np.asarray(slices, np.int64).reshape(-1, 2)
    if use_native and native.available():
        return native.block_to_dataset_index(sizes, slices)
    cum = np.concatenate([[0], np.cumsum(sizes)])
    out = np.zeros((len(slices), 3), np.int64)
    for b, (s, e) in enumerate(slices):
        sdi = int(np.searchsorted(cum, s, side="right")) - 1
        edi = sdi if e <= s else int(np.searchsorted(cum, e - 1,
                                                     side="right")) - 1
        out[b] = (sdi, s - cum[sdi], edi)
    return out
