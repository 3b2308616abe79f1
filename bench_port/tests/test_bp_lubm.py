"""``gen/lubm.py`` keeps the generator contract of ``gen/__init__.py``,
repeats per seed, draws every count of UBA's profile inside its range,
and gives LUBM(10) its size."""
import dataclasses

import numpy as np
import pytest

from bench_port import harness
from bench_port.gen import lubm as L
from bench_port.gen.sensor import seeded_rng


def _graph(seed, spec=L.LubmSpec(1)):
    v = L.Vocabulary(spec)
    return v, L.graph_rows(v, spec, seeded_rng(seed))


def test_the_generator_keeps_the_contract():
    gen = harness.generator("lubm")
    spec = gen.spec_from_config({"n_universities": 1})
    # the harness loads the module by path: another class object
    assert dataclasses.astuple(spec) == dataclasses.astuple(L.LubmSpec(1))
    v = gen.Vocabulary(spec)
    assert v.terms[:2] == ["rdf:type", "repro:instanceOf"]
    assert len(set(v.terms)) == len(v.terms)
    rows = gen.graph_rows(v, spec, seeded_rng(3))
    assert rows.dtype == np.int32 and rows.ndim == 2 and rows.shape[1] == 3
    assert rows.min() >= 0 and rows.max() < len(v.terms)
    assert np.unique(rows, axis=0).shape[0] == rows.shape[0]
    depts = rows[(rows[:, 1] == 0) & (rows[:, 2] == v.id("Department")), 0]
    assert L.DEPARTMENTS[0] <= depts.shape[0] <= L.DEPARTMENTS[1]


@pytest.mark.parametrize("seed", [4, -2, 2**31 + 77])
def test_the_graph_repeats_per_seed(seed):
    v, a = _graph(seed)
    assert np.array_equal(a, _graph(seed)[1])
    assert not np.array_equal(a, _graph(seed + 1)[1])
    assert v.terms == L.Vocabulary(L.LubmSpec(1)).terms


def _objects(rows, v, pred, subjects=None):
    """(subject, object) rows of ``pred``, optionally of ``subjects``."""
    sel = rows[:, 1] == v.id(pred)
    if subjects is not None:
        sel &= np.isin(rows[:, 0], subjects)
    return rows[sel][:, [0, 2]].astype(np.int64)


def _per(subjects, rows2):
    """Objects per subject of the sorted ``subjects``, zero included."""
    pos = np.searchsorted(subjects, rows2[:, 0])
    pos_c = np.minimum(pos, subjects.shape[0] - 1)
    hit = (pos < subjects.shape[0]) & (subjects[pos_c] == rows2[:, 0])
    return np.bincount(pos[hit], minlength=subjects.shape[0])


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 5])
def test_every_count_lies_in_the_profile(seed):
    v, rows = _graph(seed)
    typ = rows[rows[:, 1] == 0].astype(np.int64)

    def of(cls):
        return np.sort(typ[typ[:, 2] == v.id(cls), 0])

    def dept(ids):
        return (np.asarray(ids) - v.start["dept"]) // v.slot

    depts = dept(of("Department"))
    assert 15 <= depts.shape[0] <= 25
    n = {c: np.bincount(dept(of(c)), minlength=depts.shape[0])
         for c in L.RANKS + ("ResearchGroup", "UndergraduateStudent",
                             "GraduateStudent", "TeachingAssistant",
                             "ResearchAssistant")}
    for c, (lo, hi) in zip(L.RANKS, L.RANK_RANGES):
        assert lo <= n[c].min() and n[c].max() <= hi, c
    assert 10 <= n["ResearchGroup"].min() <= n["ResearchGroup"].max() <= 20
    fac = sum(n[c] for c in L.RANKS)
    ug, gr = n["UndergraduateStudent"], n["GraduateStudent"]
    assert (ug % fac == 0).all() and (gr % fac == 0).all()
    assert 8 <= (ug // fac).min() and (ug // fac).max() <= 14
    assert 3 <= (gr // fac).min() and (gr // fac).max() <= 4
    ta, ra = n["TeachingAssistant"], n["ResearchAssistant"]
    assert ((ta == gr // 4) | (ta == gr // 5)).all()
    assert ((ra == gr // 3) | (ra == gr // 4)).all()
    grads = of("GraduateStudent")
    assistants = np.concatenate([of("TeachingAssistant"),
                                 of("ResearchAssistant")])
    assert np.isin(assistants, grads).all()
    assert np.unique(assistants).shape[0] == assistants.shape[0]
    # courses: each taught by one faculty member of its department, 1-2
    # of each kind a teacher; students take distinct courses of their own
    teach = _objects(rows, v, "teacherOf")
    assert np.unique(teach[:, 1]).shape[0] == teach.shape[0]
    assert (dept(teach[:, 0]) == dept(teach[:, 1])).all()
    for kind, (lo, hi) in (("Course", L.COURSES_PER_FACULTY),
                           ("GraduateCourse",
                            L.GRADUATE_COURSES_PER_FACULTY)):
        per = _per(np.sort(np.concatenate([of(c) for c in L.RANKS])),
                   teach[np.isin(teach[:, 1], of(kind))])
        assert lo <= per.min() and per.max() <= hi
    for cls, kind, (lo, hi) in (
            ("UndergraduateStudent", "Course", L.UNDERGRADUATE_TAKES),
            ("GraduateStudent", "GraduateCourse", L.GRADUATE_TAKES)):
        takes = _objects(rows, v, "takesCourse", of(cls))
        assert np.isin(takes[:, 1], of(kind)).all()
        assert (dept(takes[:, 0]) == dept(takes[:, 1])).all()
        per = _per(of(cls), takes)
        assert lo <= per.min() and per.max() <= hi
        assert per.min() == lo and per.max() == hi
    # advisors: professors of the department, for every graduate and
    # about one undergraduate in five
    profs = np.concatenate([of(c) for c in L.RANKS[:3]])
    adv = _objects(rows, v, "advisor")
    assert np.isin(adv[:, 1], profs).all()
    assert (dept(adv[:, 0]) == dept(adv[:, 1])).all()
    assert (_per(grads, adv) == 1).all()
    ug_adv = _per(of("UndergraduateStudent"), adv)
    assert ug_adv.max() == 1 and 0.17 < ug_adv.mean() < 0.23
    heads = _objects(rows, v, "headOf")
    assert np.isin(heads[:, 0], of("FullProfessor")).all()
    assert np.array_equal(np.sort(heads[:, 1]), of("Department"))
    # publications by rank, one faculty author each; a graduate co-authors
    # 0-5 of its advisor's
    auth = _objects(rows, v, "publicationAuthor")
    faculty = np.sort(np.concatenate([of(c) for c in L.RANKS]))
    by_fac = auth[np.isin(auth[:, 1], faculty)]
    assert np.array_equal(np.sort(by_fac[:, 0]), of("Publication"))
    for c, (lo, hi) in zip(L.RANKS, L.PUBLICATIONS):
        per = _per(of(c), by_fac[:, ::-1])
        assert lo <= per.min() and per.max() <= hi, c
    by_grad = auth[np.isin(auth[:, 1], grads)]
    assert by_grad.shape[0] + by_fac.shape[0] == auth.shape[0]
    per = _per(grads, by_grad[:, ::-1])
    assert per.min() == 0 and per.max() == L.GRADUATE_PUBLICATIONS[1]
    first = dict(by_fac.tolist())
    advisor = dict(adv.tolist())
    assert all(first[p] == advisor[g] for p, g in by_grad.tolist())
    # literals: one telephone, unique e-mails, names that repeat across
    # departments, degrees from the 1000 universities
    people = np.concatenate([of(c) for c in L.RANKS] + [
        of("UndergraduateStudent"), grads])
    tel = _objects(rows, v, "telephone")
    assert np.array_equal(np.sort(tel[:, 0]), np.sort(people))
    assert set(tel[:, 1].tolist()) == {v.id(L.TELEPHONE)}
    mail = _objects(rows, v, "emailAddress")
    assert np.unique(mail[:, 1]).shape[0] == people.shape[0]
    names = _objects(rows, v, "name", of("UndergraduateStudent"))[:, 1]
    assert np.unique(names).shape[0] == ug.max()
    for p in ("undergraduateDegreeFrom", "mastersDegreeFrom",
              "doctoralDegreeFrom"):
        o = _objects(rows, v, p)[:, 1] - v.start["university"]
        assert 0 <= o.min() and o.max() < 1000
    for t in (v.terms[i] for i in np.unique(mail[:, 1])[:3]):
        assert t.startswith('"') and "@Department" in t


def test_ten_universities_give_lubm_10s_size():
    # about 1.3M triples; a graph's size follows its 150-250 departments
    spec = L.LubmSpec(10)
    v = L.Vocabulary(spec)
    sizes = [L.graph_rows(v, spec, seeded_rng(2**31 + s)).shape[0]
             for s in range(8)]
    assert 1_250_000 <= np.mean(sizes) <= 1_400_000, sizes
    assert 1_100_000 <= min(sizes) and max(sizes) <= 1_550_000, sizes


def test_a_configuration_naming_lubm_gets_its_spec():
    cfg = {"name": "lubm-2", "generator": "lubm", "n_universities": 2}
    spec = harness.generator(cfg["generator"]).spec_from_config(cfg)
    assert dataclasses.astuple(spec) == dataclasses.astuple(L.LubmSpec(2))


@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_distinct_picks_are_uniform_samples(seed):
    # 200,000 rows, each 1-5 distinct values of [0, 12): every value is
    # drawn about as often (within five standard deviations of a count),
    # by rows of every size
    rng = seeded_rng(seed)
    n, avail = 200_000, 12
    k = rng.integers(1, 6, n)
    row, val = L._distinct(rng, np.full(n, avail), k)
    assert np.array_equal(np.bincount(row, minlength=n), k)
    pairs = row * avail + val
    assert np.unique(pairs).shape[0] == pairs.shape[0]
    assert val.min() == 0 and val.max() == avail - 1
    for size in range(1, 6):
        hits = np.bincount(val[k[row] == size], minlength=avail)
        want = (k == size).sum() * size / avail
        assert np.abs(hits - want).max() < 5 * np.sqrt(want), (size, hits)


@pytest.mark.parametrize("seed", [1, 2])
def test_courses_and_coauthored_publications_spread_over_the_index(seed):
    # the courses a student takes and the advisor's publications a
    # graduate co-authors lie, on average, half way along what is there
    v, rows = _graph(seed)
    typ = rows[rows[:, 1] == 0].astype(np.int64)

    def of(cls):
        return np.sort(typ[typ[:, 2] == v.id(cls), 0])

    def local(ids, block):
        return (np.asarray(ids) - v.start["dept"]) % v.slot - v.off[block]

    for cls, kind in (("UndergraduateStudent", "Course"),
                      ("GraduateStudent", "GraduateCourse")):
        takes = _objects(rows, v, "takesCourse", of(cls))
        dept = (takes[:, 1] - v.start["dept"]) // v.slot
        per_dept = np.bincount((of(kind) - v.start["dept"]) // v.slot,
                               minlength=dept.max() + 1)
        share = (local(takes[:, 1], kind) + 0.5) / per_dept[dept]
        assert abs(share.mean() - 0.5) < 0.03, (cls, share.mean())
    auth = _objects(rows, v, "publicationAuthor")
    faculty = np.sort(np.concatenate([of(c) for c in L.RANKS]))
    by_fac = auth[np.isin(auth[:, 1], faculty)]
    n_pub = dict(zip(*np.unique(by_fac[:, 1], return_counts=True)))
    by_grad = auth[~np.isin(auth[:, 1], faculty)]
    first = dict(by_fac.tolist())
    k = local(by_grad[:, 0], "Publication") % v.pubs_each
    avail = np.array([n_pub[first[p]] for p in by_grad[:, 0].tolist()])
    share = (k + 0.5) / avail
    assert abs(share.mean() - 0.5) < 0.03, share.mean()
