"""The port's triple-row sorts and searches against the JAX package's
``core.index``: ``sort_unique``, ``setdiff_rows``, ``merge_disjoint``,
``in_sorted`` over row keys, ``GraphIndex``'s rows, predicates and CSR
starts, and ``fgraph._keep_mask``, on seeded random rows whose column
ranges take the packed int64 key (small ids, widths summing to exactly
63, negative ids, large ids over narrow ranges), the structured fallback
(64 bits or more, ids up to 2**31 - 1), empty and one-row arrays, and
pairs whose maxima differ by many bits -- keys of one pair share offsets
and widths, so they must be built in one call.  Each case checks the
kind of key ``row_keys`` builds for the arrays each function keys: an
int64, or a structured view."""
import numpy as np
import pytest

from repro.core import index as jidx
from repro_torch.core import index as tidx
from repro_torch.core.fgraph import _keep_mask

I32 = 2**31 - 1
TYPE_ID, INSTANCE_OF_ID = 1, 2

# name: (column maxima of a, of b, the ids' floor, rows of a, rows of b)
CASES = {
    "small": ((900, 15, 900), (1000, 12, 700), 0, 400, 300),
    "sum63": ((2**21 - 1, 2**21 - 1, 2**21 - 1),
              (2**20, 2**21 - 1, 2**19), 0, 400, 300),
    "sum63-wide-ends": ((I32, 1, I32), (2**30, 1, I32), 0, 400, 300),
    "sum64": ((I32, 3, I32), (I32, 2, 2**30), 0, 400, 300),
    "int32-max": ((I32, I32, I32), (I32, I32, I32), 0, 400, 300),
    "negative": ((50, 9, 50), (40, 9, 60), -50, 400, 300),
    # ids of 31 bits over ranges of 11: packed from each column's minimum
    "high-narrow": ((2**30 + 2**10,) * 3, (2**30 + 2**10,) * 3, 2**30,
                    400, 300),
    "empty": ((900, 15, 900), (900, 15, 900), 0, 0, 300),
    "one-row": ((900, 15, 900), (900, 15, 900), 0, 1, 1),
    # the hazard: maxima many bits apart, but the pair still packs
    "far-maxima": ((15, 3, 15), (2**20, 2**4, 2**20), 0, 300, 400),
    # each side packs alone (33 bits), the pair needs 64: void
    "far-maxima-sum64": ((I32, 1, 1), (1, 3, I32), 0, 300, 400),
}
# the key each pair of a case must take
PAIR_KIND = {"small": "packed", "sum63": "packed",
             "sum63-wide-ends": "packed", "sum64": "void",
             "int32-max": "void", "negative": "packed",
             "high-narrow": "packed", "empty": "packed",
             "one-row": "packed", "far-maxima": "packed",
             "far-maxima-sum64": "void"}
PERMS = {"spo": (0, 1, 2), "pso": (1, 0, 2)}
FUNCS = ["sort_unique", "setdiff_rows", "merge_disjoint", "in_sorted",
         "graph_index", "keep_mask"]


def _rows(rng, n, maxima, floor):
    """``n`` rows with column j in [floor, maxima[j]], each maximum
    present, and a tenth of the rows repeated."""
    rows = np.stack([rng.integers(floor, m, n, endpoint=True,
                                  dtype=np.int64) for m in maxima], axis=1)
    if n:
        rows[rng.integers(0, n, 3)] = maxima
    if n > 1:
        rows = np.concatenate([rows, rows[rng.integers(0, n, n // 10)]])
    return rows.astype(np.int32)


def _pair(name, seed):
    """Rows ``a`` and ``b``, where ``b`` also holds those rows of ``a``
    that fit under ``b``'s maxima (so its widths stay its own)."""
    amax, bmax, floor, na, nb = CASES[name]
    rng = np.random.default_rng(seed)
    a = _rows(rng, na, amax, floor)
    b = _rows(rng, nb, bmax, floor)
    shared = a[(a <= np.asarray(bmax)).all(axis=1)][:na // 3]
    if nb:
        b = np.concatenate([b, shared])
    return a, b


def _kind(*arrays):
    """The key a call over ``arrays`` must build, worked out apart from
    the port: packed iff the bit widths of the columns' ranges fit."""
    arrays = [x for x in arrays if x.shape[0]]
    bits = sum(max(1, (max((int(x[:, j].max()) for x in arrays), default=0)
                       - min((int(x[:, j].min()) for x in arrays),
                             default=0)).bit_length()) for j in range(3))
    return "packed" if bits <= 63 else "void"


def _built(perm, *arrays):
    """The kind of key the port's ``row_keys`` builds over ``arrays``:
    one int64 per row, or the structured view of the row."""
    kinds = set()
    for key in tidx.row_keys(perm, *arrays):
        if key.dtype == np.int64:
            kinds.add("packed")
        else:
            assert key.dtype.names and len(key.dtype.names) == 3
            assert {f[0] for f in key.dtype.fields.values()} \
                == {np.dtype(np.int32)}
            kinds.add("void")
    assert len(kinds) == 1
    return kinds.pop()


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("func", FUNCS)
@pytest.mark.parametrize("perm", PERMS)
@pytest.mark.parametrize("name", CASES)
def test_row_sorts_and_searches_match_reference(name, perm, func):
    perm = PERMS[perm]
    a, b = _pair(name, seed=sum(map(ord, name + func)) + perm[0])
    assert _kind(a, b) == PAIR_KIND[name]
    # sorted-unique under perm, as the row functions expect
    sa, sb = jidx.sort_unique(a, perm), jidx.sort_unique(b, perm)
    assert _built(perm, a, b) == PAIR_KIND[name]
    # the arrays of each row_keys call the function makes
    if func == "sort_unique":
        for rows in (a, b):
            _same(tidx.sort_unique(rows, perm), jidx.sort_unique(rows, perm))
        keyed = [(x,) for x in (a, b) if x.shape[0] > 1]
    elif func == "setdiff_rows":
        _same(tidx.setdiff_rows(sa, sb, perm),
              jidx.setdiff_rows(sa, sb, perm))
        keyed = [(sa, sb)] if sa.shape[0] and sb.shape[0] else []
    elif func == "merge_disjoint":
        fresh = jidx.setdiff_rows(sb, sa, perm)
        _same(tidx.merge_disjoint(sa, fresh, perm),
              jidx.merge_disjoint(sa, fresh, perm))
        keyed = [(sa, fresh)] if sa.shape[0] and fresh.shape[0] else []
    elif func == "in_sorted":
        _same(tidx.in_sorted(*tidx.row_keys(perm, a, sb)),
              jidx.in_sorted(jidx._key_view(a, perm),
                             jidx._key_view(sb, perm)))
        keyed = [(a, sb)]
    elif func == "graph_index":
        for rows in (a, b):
            spo = jidx.sort_unique(rows)
            got = tidx.GraphIndex(spo, TYPE_ID, INSTANCE_OF_ID)
            want = jidx.GraphIndex(spo, TYPE_ID, INSTANCE_OF_ID)
            _same(got.rows, want.rows)
            np.testing.assert_array_equal(got.preds, want.preds)
            np.testing.assert_array_equal(got.starts, want.starts)
        keyed = [(x,) for x in (a, b) if x.shape[0] > 1]
    else:
        # the delete path's mask: rows of the store (sorted-unique under
        # perm) that are not among the dropped rows
        got = _keep_mask(sb, a, perm)
        want = ~jidx.in_sorted(
            jidx._key_view(sb, perm),
            jidx._key_view(jidx.sort_unique(a, perm), perm)) \
            if sb.shape[0] else np.ones(0, bool)
        _same(got, want)
        keyed = [(sb, sa)] if sb.shape[0] else []
        if sb.shape[0] and a.shape[0] > 1:
            keyed.append((a,))
    for arrays in keyed:
        assert _built(perm, *arrays) == _kind(*arrays)


def test_a_packed_key_orders_as_the_rows_do():
    """Keys of one call compare as their rows do lexicographically, and
    keys of a pair whose maxima are far apart keep that across arrays."""
    a, b = _pair("far-maxima", seed=5)
    ka, kb = tidx.row_keys((0, 1, 2), a, b)
    assert ka.dtype == kb.dtype == np.int64
    rows = np.concatenate([a, b]).tolist()
    keys = np.concatenate([ka, kb]).tolist()
    order = sorted(range(len(rows)), key=lambda i: keys[i])
    assert [rows[i] for i in order] == sorted(rows)
