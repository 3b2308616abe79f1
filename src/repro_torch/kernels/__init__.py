"""Hand-written CUDA kernels, with plain versions.

``sig_hash.py`` and ``seg_count.py`` (the FSP group-by) and
``flash_attention.py`` and ``linear_scan.py`` (the LM serve path) wrap
the ``csrc/`` kernels, built by ``build.py`` on first use, beside their
plain torch versions; ``ref.py`` holds the arithmetic those share,
``chunked_attention.py`` the plain-torch decode attention, and
``ops.py`` the device-dispatching entry points the rest of the package
calls.
"""
