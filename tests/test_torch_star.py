"""The port's exact grouping of object-matrix rows, ``core.star.row_groups``,
against the JAX package's: the same group of each row, group counts and
first rows, array for array, on seeded matrices whose column ranges take
the packed int64 key (the compaction cell's five columns, widths summing
to exactly 63, negative ids, one column, empty and one-row matrices,
rows all equal) and on those that take the structured (void) view
(widths summing to 64, wide token rows).  Each case checks the kind of
key ``index.row_keys`` builds over the matrix: an int64, or a structured
view.  ``star_groups`` is checked on a sensor graph: the same entities
and object rows, group by group."""
import numpy as np
import pytest

from repro.api import Compactor as JCompactor
from repro.core import star as jstar
from repro.data import synthetic as jsyn
from repro_torch.convert import store_from_arrays
from repro_torch.core import index as tidx
from repro_torch.core import star as tstar

I32 = 2**31 - 1

# name: (per-column (lowest, highest) id, rows, the key the grouping takes)
CASES = {
    # the shape of the sensor cell's Observation matrix over all of S:
    # 4 + 8 + 8 + 18 + 18 bits from each column's minimum
    "cell": ([(13, 21), (31, 230), (31, 230), (2**18 + 7, 2**19 - 3),
              (2**19 + 11, 2**19 + 2**18 - 1)], 3000, "packed"),
    "sum63": ([(5, 5 + 2**21 - 1)] * 3, 2000, "packed"),
    "sum64": ([(5, 5 + 2**21 - 1)] * 2 + [(0, 2**22 - 1)], 2000, "void"),
    "negative": ([(-50, 50), (-2**20, 3), (-7, -1)], 2000, "packed"),
    "int32-range": ([(-I32 - 1, I32)] * 2, 1000, "void"),
    "empty": ([(0, 900)] * 5, 0, "packed"),
    "one-row": ([(0, 900)] * 5, 1, "packed"),
    "one-column": ([(-I32 - 1, I32)], 2000, "packed"),
    # prompts of 256 tokens over a 32k vocabulary: 256 columns
    "tokens": ([(0, 31_999)] * 256, 400, "void"),
    "all-equal": ([(2**30, 2**30)] * 4, 500, "packed"),
}


def _matrix(name):
    ranges, n, _ = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    if n == 0:
        return np.empty((0, len(ranges)), np.int32)
    cols = [rng.integers(lo, hi, n, endpoint=True, dtype=np.int64)
            for lo, hi in ranges]
    mat = np.stack(cols, axis=1)
    if n > 2:
        # each column's ends present, and a fifth of the rows repeated
        mat[0] = [lo for lo, _ in ranges]
        mat[1] = [hi for _, hi in ranges]
        mat = np.concatenate([mat, mat[rng.integers(0, n, n // 5)]])
        mat = mat[rng.permutation(mat.shape[0])]
    return mat.astype(np.int32)


@pytest.mark.parametrize("name", CASES)
def test_row_groups_match_reference(name):
    mat = _matrix(name)
    (key,) = tidx.row_keys(range(mat.shape[1]), mat)
    if CASES[name][2] == "packed":
        assert key.dtype == np.int64
    else:
        assert len(key.dtype.names) == mat.shape[1]
        assert {f[0] for f in key.dtype.fields.values()} \
            == {np.dtype(np.int32)}
    got = tstar.row_groups(mat)
    want = jstar.row_groups(mat)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    # the rows in group order, each group's rows in index order
    order = tstar._row_groups(mat, with_order=True)[3]
    np.testing.assert_array_equal(order, np.argsort(want[0], kind="stable"))


def test_star_groups_match_reference():
    ref = jsyn.generate(jsyn.SensorGraphSpec(n_observations=1500, seed=4))
    store = store_from_arrays(list(ref.dict._terms), ref.spo)
    plan = JCompactor("gfsp", "host").run(ref).plan
    assert plan
    for e in plan:
        full = tuple(int(p) for p in ref.class_stats(e.class_id).properties)
        for props in {tuple(e.props), full}:
            got = tstar.star_groups(store, e.class_id, props)
            want = jstar.star_groups(ref, e.class_id, props)
            assert len(got) == len(want) > 0
            for (ents, row), (jents, jrow) in zip(got, want):
                np.testing.assert_array_equal(ents, jents)
                np.testing.assert_array_equal(row, jrow)
