"""The port's k-mer hashing (numpy and int64-torch forms) equals the JAX package's."""

import numpy as np
import torch

from xspect2_tpu.core import hashing as jax_hashing
from xspect2_tpu_torch.core import hashing


def _pairs(n=100_000, seed=2024):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    # the extremes of both words
    hi[:4] = [0, 0, 0xFFFFFFFF, 0xFFFFFFFF]
    lo[:4] = [0, 0xFFFFFFFF, 0, 0xFFFFFFFF]
    return hi, lo


def test_kmer_hash_words_numpy_and_torch_match_jax_package():
    hi, lo = _pairs()
    want = jax_hashing.kmer_hash_words(hi, lo, xp=np)
    got_np = hashing.kmer_hash_words(hi, lo)
    got_t = hashing.kmer_hash_words_torch(
        torch.from_numpy(hi.astype(np.int64)), torch.from_numpy(lo.astype(np.int64))
    )
    for w, g_np, g_t in zip(want, got_np, got_t):
        np.testing.assert_array_equal(g_np, w)
        np.testing.assert_array_equal(g_t.numpy(), w.astype(np.int64))


def test_block_words_fieldbase_forms_match_jax_package():
    hi, lo = _pairs(20_000, seed=7)
    for num_blocks, rpb, h, fpw in ((1000, 128, 7, 1), (77_777, 128, 2, 4), (16, 8, 3, 32)):
        want = jax_hashing.block_words_fieldbase(hi, lo, num_blocks, rpb, h, fpw, xp=np)
        got_np = hashing.block_words_fieldbase(hi, lo, num_blocks, rpb, h, fpw)
        got_t = hashing.block_words_fieldbase_torch(
            torch.from_numpy(hi.astype(np.int64)),
            torch.from_numpy(lo.astype(np.int64)),
            num_blocks, rpb, h, fpw,
        )
        for w, g_np, g_t in zip(want, got_np, got_t):
            np.testing.assert_array_equal(g_np, w)
            np.testing.assert_array_equal(g_t.numpy(), w.astype(np.int64))
