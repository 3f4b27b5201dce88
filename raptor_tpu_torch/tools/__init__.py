"""The repo's scripts beside the JAX package (`examples/quickstart.py`,
`tools/*.py`, `experiments/probe_collect_parity.py`), ported: each a module
run with `python -m raptor_tpu_torch.tools.<name>`. None writes a file
unless `--out` names one."""
