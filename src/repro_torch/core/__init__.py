"""The measurement machinery the probes wrap (ported from ``repro.core``):

  - chains: the instruction table (this slice: the 15 quick rows)
  - measure: one op's two-length slope latency, split into prepare / run
  - membench: the pointer-chase memory probe and its ring
  - optlevels: the O0 (eager) / O3 (torch.compile, Inductor) axis
  - latency_db: persistent result tables + failures, the JAX package's format
  - timing: Timer (CUDA events on the card, the host clock on the CPU)
"""
