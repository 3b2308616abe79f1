"""Hand-written CUDA kernels for the FSP group-by, with plain versions.

``sig_hash.py`` and ``seg_count.py`` wrap the ``csrc/`` kernels (built by
``build.py`` on first use) beside their plain torch versions; ``ref.py``
holds the murmur3 and boundary arithmetic those share, and ``ops.py``
the device-dispatching entry points the rest of the package calls.
"""
