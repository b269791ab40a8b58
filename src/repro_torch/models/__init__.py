"""Dense transformer models of the catalog, for serving (prefill and decode).

Counterpart of ``repro.models``: ``config`` (a copy of the JAX package's
``ModelConfig``), ``layers``, ``attention`` and ``transformer``.  MoE,
Mamba2 and RWKV6 blocks wait for later slices (ROADMAP Queue 1).
"""
