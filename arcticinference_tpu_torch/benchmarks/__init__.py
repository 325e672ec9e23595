"""The port's benchmarks: the headline bench's drafter distillation and
the decode weight-stream microbenchmark (``python -m
arcticinference_tpu_torch.benchmarks.<name>``)."""
