"""The port's token blocks (`vln_goat_tpu_torch.data.token_block`, fairseq's
token_block_utils_fast) against the JAX package's numpy path
(`vln_goat_tpu.data.token_block` with use_native=False, so that the JAX
package's native library is never built or loaded here): the port's numpy
path and its native path (the port's own g++ build of
`native/csrc/goat_native.cpp`) in every break mode, with
`document_sep_len`, `block_multiple_min / max` and `block_sizes`, on
fixed cases and, by hypothesis, on random sentence lengths; and
`block_to_dataset_index` of the slices."""
import shutil

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from vln_goat_tpu.data import token_block as jtb
from vln_goat_tpu_torch import native
from vln_goat_tpu_torch.data import token_block as ptb

MODES = ("none", "eos", "complete", "complete_doc")
SIZES = np.array([5, 3, 1, 7, 2, 1, 4], np.int64)
NATIVE = [False] + ([True] if shutil.which("g++") else [])


def _all_paths(sizes, block_size, mode, **kw):
    """The JAX numpy slices and the port's on each of its paths, with
    block_to_dataset_index of each."""
    ref = jtb.token_block_slices(sizes, block_size, mode, use_native=False,
                                 **kw)
    ref_idx = jtb.block_to_dataset_index(sizes, ref, use_native=False)
    for use_native in NATIVE:
        got = ptb.token_block_slices(sizes, block_size, mode,
                                     use_native=use_native, **kw)
        assert got.dtype == np.int64 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        idx = ptb.block_to_dataset_index(sizes, ref, use_native=use_native)
        np.testing.assert_array_equal(idx, ref_idx)
    return ref


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("block_size", [1, 4, 6, 8, 30])
def test_fixed_sizes_match_jax(mode, block_size):
    _all_paths(SIZES, block_size, mode)


@pytest.mark.parametrize("mode", ["complete", "complete_doc"])
@pytest.mark.parametrize("kw", [
    dict(document_sep_len=2), dict(block_multiple_min=2),
    dict(block_multiple_max=3, block_sizes=np.array([4, 9, 2, 12, 5, 7, 3,
                                                     8, 6, 10, 11, 4])),
    dict(block_multiple_min=2, block_multiple_max=2,
         block_sizes=np.full(12, 3))], ids=["sep2", "min2", "sizes", "min2max2"])
def test_block_parameters_match_jax(mode, kw):
    _all_paths(SIZES, 4, mode, **kw)


@settings(max_examples=60, deadline=None, database=None)
@given(sizes=st.lists(st.integers(0, 12), max_size=40),
       block_size=st.integers(1, 24), mode=st.sampled_from(MODES),
       sep=st.integers(1, 3), mult_min=st.integers(1, 3),
       mult_max=st.integers(1, 3), seed=st.integers(0, 2**16))
def test_random_sizes_match_jax(sizes, block_size, mode, sep, mult_min,
                                mult_max, seed):
    block_sizes = np.random.default_rng(seed).integers(
        1, 30, len(sizes) + 2) if mult_max > 1 else None
    _all_paths(np.asarray(sizes, np.int64), block_size, mode,
               document_sep_len=sep, block_multiple_min=mult_min,
               block_multiple_max=mult_max, block_sizes=block_sizes)


def test_semantics():
    """The JAX package's hand-checked cases (tests/test_token_block.py)."""
    s = ptb.token_block_slices(SIZES, 6, "none", use_native=False)
    assert s[0].tolist() == [0, 6] and s[-1, 1] == SIZES.sum()
    s = ptb.token_block_slices(SIZES, 8, "complete", use_native=False)
    assert s[0].tolist() == [0, 8] and s[-1, 1] == SIZES.sum()
    s = ptb.token_block_slices(SIZES, 8, "complete_doc", use_native=False)
    assert np.all(s[:, 1] - s[:, 0] > 1)
    out = ptb.block_to_dataset_index(np.array([4, 2, 3]),
                                     np.array([[0, 4], [4, 6], [2, 8]]),
                                     use_native=False)
    assert out.tolist() == [[0, 0, 0], [1, 0, 1], [0, 2, 2]]


def test_invalid_mode_raises():
    for use_native in NATIVE:
        with pytest.raises(ValueError, match="invalid break_mode"):
            ptb.token_block_slices(SIZES, 4, "sentence", use_native=use_native)


def test_native_path_taken_when_built():
    if not NATIVE[-1]:
        pytest.skip("no g++: the native path is not built")
    assert native.available()
