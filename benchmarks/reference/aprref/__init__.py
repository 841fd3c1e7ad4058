"""A frozen copy of the port's plain code (apr_torch at commit bc3af59), the
benchmark's reference.  It imports nothing of apr_torch and launches no
kernel of the port: K1 and K2 run their plain versions on every device.
What no cell runs is left out: the data-parallel (mesh) paths, the
testers' ``test`` / ``test_sharded`` loops and capacity buckets, and the
SimpleNet encoders."""

import torch

# as the port: TF32 stays off for matmuls and convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
