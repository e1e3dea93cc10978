"""Repeat the CTC kernels on chip_smoke.py's U = 512 (S = 1025) check case.

Run from the root of a checkout on a CUDA machine:
``CUDA_LAUNCH_BLOCKING=1 python3 scripts/ctc_u512_repeat.py [REPEATS]``.
Each repeat runs the forward and gradient kernels on the case's three
seeds and synchronises; the script exits 3 at the first failure, and
ends with one run of the plain version in float64.
"""
import os, sys, time
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from stylish_tts_torch.ops import ctc_cuda
ctc_cuda.build()
spec = dict(b=4, t=1100, c=179, u=512, label_lengths=[512, 400, 300, 511], input_lengths=[1100, 1000, 900, 1100])
for rep in range(int(sys.argv[1]) if len(sys.argv) > 1 else 20):
    for seed in (102, 103, 104):
        case = cs.make_case(torch, seed=seed, **spec)
        try:
            k_loss, k_grad = cs.run_kernel(torch, case)
            torch.cuda.synchronize()
        except Exception as e:
            print("rep", rep, "seed", seed, "kernel FAILED", repr(e)[:200], flush=True)
            sys.exit(3)
    print("rep", rep, "ok", float(k_loss.sum()), flush=True)
case = cs.make_case(torch, seed=102, **spec)
d_loss, d_grad = cs.run_plain(torch, case, torch.float64)
torch.cuda.synchronize()
print("plain fp64 ok", float(d_loss.sum()))
