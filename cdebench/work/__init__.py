"""Each solver's work: model FLOPs and its fused kernel's least times.

One file per method, ``<method>.py``, found by the configuration's
``solver``; each has ``work(model, batch, length, counts)``, which gives,
for each fused kernel, its least times and ``names``: the patterns of its
device operations' names, by which the per-layer readers find it.
"""
