"""Runnable examples of the port, the counterparts of the repository's
examples/*.py. Each takes a device (the CUDA card unless --device cpu):
python -m dqc_tpu_torch.examples.<name> [--device cpu]."""
