"""The benchmark of the PyTorch/CUDA port (gf_orb_slam2_tpu_torch): see
run.py and PERF.md."""
