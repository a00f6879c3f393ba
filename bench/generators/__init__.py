"""Surrogate generators, one file each, found by the name that a
configuration's ``generator.name`` gives (``bench.data.generator``).

A generator module defines ``catalog(n, **params)``, the fixed universe a
configuration names (drawn on the host), and ``draw(cat, n, g, device,
**params)``, ``n`` float32 points on ``device`` drawn with the
``torch.Generator`` ``g``. Adding a generator adds a file here.
"""
