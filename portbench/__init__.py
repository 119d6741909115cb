"""The PyTorch and CUDA port's benchmark: one cell of BENCHMARK.json a run
(``python3 -m portbench.run``), its data, traffic kinds, plain references and
per-layer metric readers."""
