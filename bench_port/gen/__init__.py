"""Inputs made from the seed: the graphs.

A configuration file names its generator, ``"generator": "<module>"``,
which is ``gen/<module>.py``; without the key it is ``"sensor"``.  The
harness loads that module by its path and hands it to the driver, so a
deployment of another schema comes as a generator file and a
configuration file, with no edit to the harness or a driver.  A
generator module has three parts:

``spec_from_config(cfg) -> spec``
    The scale and shape of one graph, from the configuration file's
    object; every graph of a run shares it.
``Vocabulary(spec)``
    The term list of every graph of a spec, ``.terms``: ids are
    positions, id 0 is ``rdf:type`` and id 1 is ``repro:instanceOf`` (the
    two terms every store reserves; the reference takes them by id).
``graph_rows(vocab, spec, rng) -> (n, 3) int32``
    The id rows of one graph, drawn from a ``numpy.random.Generator``
    alone, so the same seed gives the same graph.

Both the program and the plain reference receive exactly
``(vocab.terms, rows)``.
"""
