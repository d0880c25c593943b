"""Stable multi-lane sorts (exec/sort.py) against np.lexsort.

Keys of any width go through one lax.sort over packed u64 lanes; these
cases are wider than four lanes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from velox_tpu import types as T
from velox_tpu.exec import sort as S
from velox_tpu.expression.eval import EvalValue


def _lexsort_words(words_np):
    return np.lexsort(tuple(reversed(words_np)))  # words[0] most significant


@pytest.mark.parametrize("n,bits", [
    (4096, [32] * 12),                       # 6 full lanes
    (5000, [1, 17, 32, 5, 32, 32, 32, 32, 32, 32, 32, 9]),  # 5 lanes
])
def test_wide_word_sort_matches_lexsort(n, bits):
    rng = np.random.default_rng(len(bits) + n)
    # few distinct values per word, so later lanes decide most ties
    words_np = [rng.integers(0, min(1 << b, 3), n).astype(np.uint32)
                for b in bits[:-1]]
    words_np.append(rng.integers(0, 1 << bits[-1], n).astype(np.uint32))
    words = [jnp.asarray(w) for w in words_np]
    perm, lanes = jax.jit(lambda ws: S.sort_perm_key(ws, bits, n))(words)
    assert len(lanes) == -(-sum(bits) // 64) > 4
    np.testing.assert_array_equal(np.asarray(perm),
                                  _lexsort_words(words_np))
    packed = S.pack_words_u64(words, bits)
    for sorted_lane, lane in zip(lanes, packed):
        np.testing.assert_array_equal(np.asarray(sorted_lane),
                                      np.asarray(lane)[np.asarray(perm)])


def test_seven_bigint_keys_with_nulls_and_desc():
    """sort_permutation over 7 nullable BIGINT keys (456 key bits with the
    active and null bits: 8 lanes), mixed directions, vs a Python sort."""
    from velox_tpu.core.plan import SortOrder
    n, cap = 3000, 3072
    rng = np.random.default_rng(7)
    cols = [rng.integers(-3, 3, n).astype(np.int64) for _ in range(7)]
    nulls = [rng.random(n) < 0.1 for _ in range(7)]
    orders = [list(SortOrder)[i % 4] for i in range(7)]
    datas, valids = [], []
    for c, m in zip(cols, nulls):
        datas.append(jnp.asarray(np.pad(c, (0, cap - n))))
        valids.append(jnp.asarray(np.pad(~m, (0, cap - n))))

    @jax.jit
    def perm_of(datas, valids):
        keys = [EvalValue(d, v, T.BIGINT) for d, v in zip(datas, valids)]
        return S.sort_permutation(keys, orders, cap, jnp.arange(cap) < n)

    perm = np.asarray(perm_of(datas, valids))

    def key(i):
        out = []
        for c, m, o in zip(cols, nulls, orders):
            null_rank = 0 if m[i] == o.nulls_first else 1
            v = 0 if m[i] else (c[i] if o.ascending else -c[i])
            out.append((null_rank, v))
        return out

    exp = sorted(range(n), key=key)  # Python's sort is stable
    np.testing.assert_array_equal(perm[:n], exp)
    assert set(perm[n:].tolist()) == set(range(n, cap))
