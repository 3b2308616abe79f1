"""LUBM graphs (Guo, Pan & Heflin, "LUBM: A benchmark for OWL knowledge
base systems", J. Web Semantics 3(2-3), 2005) as id rows plus a term
list, made from a seed: a vectorized numpy generator of the shape UBA,
the benchmark's data generator, gives a university.

Every number of the profile (the module's constants) is UBA's as this
repository records it, assumed and not checked against UBA's source: a
university has 15-25 departments; a department 7-10 full, 10-14
associate and 8-11 assistant professors, 5-7 lecturers and 10-20
research groups, 8-14 undergraduate and 3-4 graduate students per
faculty member (one ratio a department); every faculty member teaches
1-2 courses and 1-2 graduate courses; an undergraduate takes 2-4 of the
department's courses, a graduate 1-3 of its graduate courses; one
undergraduate in five and every graduate has a professor of the
department as advisor; full professor 0 heads the department; a full,
associate or assistant professor or a lecturer writes 15-20, 10-18,
5-10 or 0-5 publications (``name``, ``publicationAuthor``), and a
graduate co-authors 0-5 of its advisor's; one graduate in 4-5 is a
teaching assistant of one of the department's courses and one in 3-4 a
research assistant, each a second type of the graduate's URI; degrees
come from University0-999.  Every range is inclusive.

Literals repeat as UBA's do: ``name`` is ``"<Kind><i>"`` with ``i`` the
index inside the department, the same in every department; the e-mail
address is unique per person; the telephone is the constant
``"xxx-xxx-xxxx"``; a professor's research interest is one of 30.
Literals are quoted terms, URIs are not, so no literal is a URI.

Ids are positions in the term list: ``rdf:type`` and
``repro:instanceOf`` first (the two ids every store reserves), then the
classes, predicates, literals, the 1000 universities and one block of
fixed size for every department a spec can hold, laid out for the
profile's maxima, so every graph of a spec shares the term list.
"""
from __future__ import annotations

import dataclasses

import numpy as np

RDF_TYPE = "rdf:type"
INSTANCE_OF = "repro:instanceOf"
RANKS = ("FullProfessor", "AssociateProfessor", "AssistantProfessor",
         "Lecturer")
CLASSES = ("University", "Department", "ResearchGroup", *RANKS,
           "UndergraduateStudent", "GraduateStudent", "TeachingAssistant",
           "ResearchAssistant", "Course", "GraduateCourse", "Publication")
PREDICATES = ("name", "emailAddress", "telephone", "memberOf", "worksFor",
              "headOf", "subOrganizationOf", "takesCourse", "teacherOf",
              "advisor", "teachingAssistantOf", "undergraduateDegreeFrom",
              "mastersDegreeFrom", "doctoralDegreeFrom", "researchInterest",
              "publicationAuthor")
TELEPHONE = '"xxx-xxx-xxxx"'


# UBA's profile (inclusive ranges; publications by rank, in RANKS order)
DEPARTMENTS = (15, 25)
RANK_RANGES = ((7, 10), (10, 14), (8, 11), (5, 7))
RESEARCH_GROUPS = (10, 20)
UNDERGRADUATES_PER_FACULTY = (8, 14)
GRADUATES_PER_FACULTY = (3, 4)
COURSES_PER_FACULTY = (1, 2)
GRADUATE_COURSES_PER_FACULTY = (1, 2)
UNDERGRADUATE_TAKES = (2, 4)
GRADUATE_TAKES = (1, 3)
UNDERGRADUATE_ADVISOR_ONE_IN = 5
PUBLICATIONS = ((15, 20), (10, 18), (5, 10), (0, 5))
GRADUATE_PUBLICATIONS = (0, 5)
TEACHING_ASSISTANT_ONE_IN = (4, 5)
RESEARCH_ASSISTANT_ONE_IN = (3, 4)
DEGREE_UNIVERSITIES = 1000
RESEARCH_INTERESTS = 30


@dataclasses.dataclass(frozen=True)
class LubmSpec:
    """The scale of one graph: its number of universities.  UBA's
    profile is fixed (the module's constants)."""

    n_universities: int


def spec_from_config(cfg: dict) -> LubmSpec:
    """The spec of a configuration file: ``n_universities``, its only
    number."""
    return LubmSpec(int(cfg["n_universities"]))


class Vocabulary:
    """The term list of every graph of one spec, and the id blocks in it.

    A department ``k`` (university ``k // max departments``, department
    ``k % max departments``) owns the ids ``dept0 + k * slot`` on: itself,
    its research groups, its faculty by rank, undergraduates, graduates,
    courses, graduate courses, publications (``pubs_each`` a faculty
    slot) and one e-mail address per person slot, each block as large as
    the profile's maximum."""

    def __init__(self, spec: LubmSpec) -> None:
        terms = [RDF_TYPE, INSTANCE_OF, *(f"ub:{c}" for c in CLASSES),
                 *(f"ub:{p}" for p in PREDICATES), TELEPHONE]
        self.base = {t: i for i, t in enumerate(terms)}
        self.max_depts = DEPARTMENTS[1]
        self.rank_max = [hi for _, hi in RANK_RANGES]
        fac = sum(self.rank_max)
        self.pubs_each = max(hi for _, hi in PUBLICATIONS)
        sizes = {"dept": 1, "group": RESEARCH_GROUPS[1],
                 **{r: m for r, m in zip(RANKS, self.rank_max)},
                 "UndergraduateStudent":
                     fac * UNDERGRADUATES_PER_FACULTY[1],
                 "GraduateStudent": fac * GRADUATES_PER_FACULTY[1],
                 "Course": fac * COURSES_PER_FACULTY[1],
                 "GraduateCourse": fac * GRADUATE_COURSES_PER_FACULTY[1],
                 "Publication": fac * self.pubs_each}
        people = RANKS + ("UndergraduateStudent", "GraduateStudent")
        sizes["email"] = sum(sizes[k] for k in people)
        self.off, at = {}, 0
        for k, n in sizes.items():
            self.off[k] = at
            at += n
        self.slot = at
        self.size = sizes
        # literals: names by kind and index, interests, universities
        self.start: dict[str, int] = {}
        named = (*people, "Course", "GraduateCourse")
        for k in named:
            self.start[f"name/{k}"] = len(terms)
            terms += [f'"{k}{i}"' for i in range(sizes[k])]
        self.start["name/Publication"] = len(terms)
        terms += [f'"Publication{i}"' for i in range(self.pubs_each)]
        self.start["name/Department"] = len(terms)
        terms += [f'"Department{i}"' for i in range(self.max_depts)]
        self.start["name/University"] = len(terms)
        terms += [f'"University{i}"' for i in range(spec.n_universities)]
        self.start["interest"] = len(terms)
        terms += [f'"Research{i}"' for i in range(RESEARCH_INTERESTS)]
        self.start["university"] = len(terms)
        terms += [f"University{i}" for i in range(DEGREE_UNIVERSITIES)]
        self.start["dept"] = len(terms)
        for u in range(spec.n_universities):
            for d in range(self.max_depts):
                dp = f"Department{d}.University{u}"
                block = [dp]
                block += [f"{dp}/ResearchGroup{i}"
                          for i in range(sizes["group"])]
                for k in named:
                    block += [f"{dp}/{k}{i}" for i in range(sizes[k])]
                block += [f"{dp}/{RANKS[r]}{f}/Publication{i}"
                          for r in range(len(RANKS))
                          for f in range(self.rank_max[r])
                          for i in range(self.pubs_each)]
                block += [f'"{k}{i}@{dp}.edu"' for k in people
                          for i in range(sizes[k])]
                terms += block
        self.terms = terms

    def id(self, term: str) -> int:
        """The id of a schema term (class or predicate, unprefixed)."""
        return self.base[term if term in self.base else f"ub:{term}"]


def _local(counts: np.ndarray) -> np.ndarray:
    """The index of each element inside its segment, for segments of
    ``counts`` laid end to end."""
    counts = np.asarray(counts, np.int64)
    return (np.arange(int(counts.sum()))
            - np.repeat(np.cumsum(counts) - counts, counts))


def _draw(rng: np.random.Generator, rng_: tuple[int, int], n: int
          ) -> np.ndarray:
    lo, hi = rng_
    return rng.integers(lo, hi + 1, n)


def _distinct(rng: np.random.Generator, avail: np.ndarray, k: np.ndarray
              ) -> tuple[np.ndarray, np.ndarray]:
    """For row ``i``, ``k[i]`` distinct values of ``[0, avail[i])``:
    (row, value) pairs.  Draw ``j`` is uniform over the values not yet
    taken (it skips them, walked in ascending order), and a row keeps its
    first ``k[i]`` draws in the order they were made, so its values are
    a uniform sample."""
    n, kmax = avail.shape[0], int(k.max(initial=0))
    drawn = np.zeros((n, kmax), np.int64)
    for j in range(kmax):
        r = (rng.random(n) * np.maximum(avail - j, 1)).astype(np.int64)
        for c in np.sort(drawn[:, :j], axis=1).T:
            r += r >= c
        drawn[:, j] = r
    rows = np.repeat(np.arange(n), kmax)
    vals = drawn.reshape(-1)
    keep = (np.arange(kmax)[None, :] < k[:, None]).reshape(-1)
    return rows[keep], vals[keep]


def _arm(s, p: int, o) -> np.ndarray:
    s = np.asarray(s, np.int64)
    out = np.empty((s.shape[0], 3), np.int32)
    out[:, 0] = s
    out[:, 1] = p
    out[:, 2] = o
    return out


def graph_rows(vocab: Vocabulary, spec: LubmSpec,
               rng: np.random.Generator) -> np.ndarray:
    """The (n, 3) int32 id rows of one graph drawn from ``rng``."""
    v, off, st = vocab.id, vocab.off, vocab.start
    n_u = spec.n_universities
    n_dept = _draw(rng, DEPARTMENTS, n_u)
    uni = np.repeat(np.arange(n_u), n_dept)
    dnum = _local(n_dept)
    nd = uni.shape[0]
    base = st["dept"] + (uni * vocab.max_depts + dnum) * vocab.slot
    parts = []

    def typed(ids, cls):
        parts.append(_arm(ids, v(RDF_TYPE), v(cls)))

    # universities, departments, research groups
    typed(st["university"] + np.arange(n_u), "University")
    parts.append(_arm(st["university"] + np.arange(n_u), v("name"),
                      st["name/University"] + np.arange(n_u)))
    typed(base, "Department")
    parts.append(_arm(base, v("name"), st["name/Department"] + dnum))
    parts.append(_arm(base, v("subOrganizationOf"), st["university"] + uni))
    n_rg = _draw(rng, RESEARCH_GROUPS, nd)
    rg_d = np.repeat(np.arange(nd), n_rg)
    rg = base[rg_d] + off["group"] + _local(n_rg)
    typed(rg, "ResearchGroup")
    parts.append(_arm(rg, v("subOrganizationOf"), base[rg_d]))

    # faculty, rank after rank; a faculty slot is its rank's offset plus
    # its index, and its e-mail shares the person slot
    n_rank = np.stack([_draw(rng, r, nd) for r in RANK_RANGES], 1)
    n_fac = n_rank.sum(1)
    fac_d, fac_r, fac_i = [], [], []
    for r in range(len(RANKS)):
        fac_d.append(np.repeat(np.arange(nd), n_rank[:, r]))
        fac_r.append(np.full(fac_d[-1].shape[0], r))
        fac_i.append(_local(n_rank[:, r]))
    fac_d, fac_r, fac_i = (np.concatenate(x) for x in (fac_d, fac_r, fac_i))
    rank_off = np.cumsum([0] + vocab.rank_max[:-1])
    fac_slot = rank_off[fac_r] + fac_i
    fac = base[fac_d] + off[RANKS[0]] + fac_slot
    nf = fac.shape[0]
    rank_names = np.array([st[f"name/{r}"] for r in RANKS])
    for r, name in enumerate(RANKS):
        typed(fac[fac_r == r], name)
    parts += [
        _arm(fac, v("name"), rank_names[fac_r] + fac_i),
        _arm(fac, v("emailAddress"), base[fac_d] + off["email"] + fac_slot),
        _arm(fac, v("telephone"), np.full(nf, v(TELEPHONE))),
        _arm(fac, v("worksFor"), base[fac_d]),
        _arm(fac, v("undergraduateDegreeFrom"), st["university"]
             + rng.integers(0, DEGREE_UNIVERSITIES, nf)),
        _arm(fac, v("mastersDegreeFrom"), st["university"]
             + rng.integers(0, DEGREE_UNIVERSITIES, nf)),
        _arm(fac, v("doctoralDegreeFrom"), st["university"]
             + rng.integers(0, DEGREE_UNIVERSITIES, nf)),
    ]
    prof = fac_r < 3
    parts.append(_arm(fac[prof], v("researchInterest"), st["interest"]
                      + rng.integers(0, RESEARCH_INTERESTS,
                                     int(prof.sum()))))
    head = (fac_r == 0) & (fac_i == 0)
    parts.append(_arm(fac[head], v("headOf"), base[fac_d[head]]))

    # courses: each faculty member teaches its own, numbered in the
    # department in faculty order
    courses = {}
    for kind, rng_ in (("Course", COURSES_PER_FACULTY),
                       ("GraduateCourse", GRADUATE_COURSES_PER_FACULTY)):
        per = _draw(rng, rng_, nf)
        per_dept = np.bincount(fac_d, weights=per, minlength=nd
                               ).astype(np.int64)
        teacher = np.repeat(np.arange(nf), per)
        # faculty are grouped by rank, not department: number each
        # department's courses in the order of its teachers
        order = np.argsort(fac_d[teacher], kind="stable")
        local = np.empty(teacher.shape[0], np.int64)
        local[order] = _local(per_dept)
        ids = base[fac_d[teacher]] + off[kind] + local
        typed(ids, kind)
        parts.append(_arm(ids, v("name"), st[f"name/{kind}"] + local))
        parts.append(_arm(fac[teacher], v("teacherOf"), ids))
        courses[kind] = per_dept

    # publications, each by one faculty member; graduates co-author some
    # of their advisor's below
    n_pub = np.empty(nf, np.int64)
    for r, rng_ in enumerate(PUBLICATIONS):
        sel = fac_r == r
        n_pub[sel] = _draw(rng, rng_, int(sel.sum()))
    author = np.repeat(np.arange(nf), n_pub)
    k = _local(n_pub)
    pub = (base[fac_d[author]] + off["Publication"]
           + fac_slot[author] * vocab.pubs_each + k)
    typed(pub, "Publication")
    parts.append(_arm(pub, v("name"), st["name/Publication"] + k))
    parts.append(_arm(pub, v("publicationAuthor"), fac[author]))

    # a professor of the department for each of ``dept``'s entries, as a
    # position in the faculty arrays (rank after rank, department after
    # department inside a rank)
    n_prof = n_rank[:, :3].sum(1)
    first = (np.cumsum(n_rank, 0) - n_rank
             + np.cumsum(n_rank.sum(0)) - n_rank.sum(0))
    before = np.cumsum(n_rank, 1) - n_rank

    def professor(dept):
        pick = (rng.random(dept.shape[0]) * n_prof[dept]).astype(np.int64)
        r = ((pick >= n_rank[dept, 0]).astype(np.int64)
             + (pick >= n_rank[dept, 0] + n_rank[dept, 1]))
        return first[dept, r] + pick - before[dept, r]

    # students
    email0 = off["email"] + sum(vocab.rank_max)
    for kind, ratio, takes, course in (
            ("UndergraduateStudent", UNDERGRADUATES_PER_FACULTY,
             UNDERGRADUATE_TAKES, "Course"),
            ("GraduateStudent", GRADUATES_PER_FACULTY,
             GRADUATE_TAKES, "GraduateCourse")):
        n_st = n_fac * _draw(rng, ratio, nd)
        st_d = np.repeat(np.arange(nd), n_st)
        i = _local(n_st)
        ids = base[st_d] + off[kind] + i
        ns = ids.shape[0]
        typed(ids, kind)
        parts += [
            _arm(ids, v("name"), st[f"name/{kind}"] + i),
            _arm(ids, v("emailAddress"), base[st_d] + email0 + i),
            _arm(ids, v("telephone"), np.full(ns, v(TELEPHONE))),
            _arm(ids, v("memberOf"), base[st_d]),
        ]
        row, c = _distinct(rng, courses[course][st_d],
                           _draw(rng, takes, ns))
        parts.append(_arm(ids[row], v("takesCourse"),
                          base[st_d[row]] + off[course] + c))
        if kind == "UndergraduateStudent":
            adv = rng.random(ns) * UNDERGRADUATE_ADVISOR_ONE_IN < 1
            parts.append(_arm(ids[adv], v("advisor"),
                              fac[professor(st_d[adv])]))
            email0 += vocab.size[kind]
            continue
        adv = professor(st_d)
        parts.append(_arm(ids, v("advisor"), fac[adv]))
        row, k = _distinct(rng, n_pub[adv], np.minimum(
            _draw(rng, GRADUATE_PUBLICATIONS, ns), n_pub[adv]))
        parts.append(_arm(base[fac_d[adv[row]]] + off["Publication"]
                          + fac_slot[adv[row]] * vocab.pubs_each + k,
                          v("publicationAuthor"), ids[row]))
        parts.append(_arm(ids, v("undergraduateDegreeFrom"),
                          st["university"] + rng.integers(
                              0, DEGREE_UNIVERSITIES, ns)))
        # the first graduates of a department assist in teaching, the
        # next in research: a second type on the graduate's URI
        n_ta = n_st // _draw(rng, TEACHING_ASSISTANT_ONE_IN, nd)
        n_ra = n_st // _draw(rng, RESEARCH_ASSISTANT_ONE_IN, nd)
        ta = i < n_ta[st_d]
        ra = ~ta & (i < (n_ta + n_ra)[st_d])
        typed(ids[ta], "TeachingAssistant")
        parts.append(_arm(ids[ta], v("teachingAssistantOf"),
                          base[st_d[ta]] + off["Course"]
                          + (rng.random(int(ta.sum()))
                             * courses["Course"][st_d[ta]]).astype(np.int64)))
        typed(ids[ra], "ResearchAssistant")
    return np.concatenate(parts)
