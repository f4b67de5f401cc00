"""The port's benchmark from the repo's root (``python bench_torch.py [flags]``): the counterpart of
``bench.py``, the same as ``python -m vo_tpu_torch bench [flags]`` (vo_tpu_torch/bench.py)."""
from vo_tpu_torch.bench import main

if __name__ == "__main__":
    raise SystemExit(main())
