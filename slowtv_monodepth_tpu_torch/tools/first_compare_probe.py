"""One fresh process up to `chip_smoke.py`'s first compares: kernel 1 and cuDNN, each
against the plain version in float64 on the CPU, at the four ConvNeXt-B stage shapes.

A fault that shows only now and then in a process's first launches needs many
processes, not many launches. From the repo root, on the card:

    for i in $(seq 36); do python3 -m slowtv_monodepth_tpu_torch.tools.first_compare_probe; done

Each run prints one line: `ok <largest |kernel - plain|>` or `BAD` with, per shape,
both sides' distance to float64 and how many values are off. Exits 1 on `BAD`.
"""
from __future__ import annotations

import contextlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import torch

ATOL = 1e-5


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke
    from slowtv_monodepth_tpu_torch.ops import depthwise_conv, depthwise_conv_plain
    with contextlib.redirect_stdout(io.StringIO()):  # the build log is long
        chip_smoke.phase_device()
        chip_smoke.phase_build()
    rs = np.random.RandomState(0)  # the inputs chip_smoke's kernels phase draws first
    out = []
    for b, h, w, c in [(2, 96, 160, 128), (2, 48, 80, 256), (2, 24, 40, 512), (2, 12, 20, 1024)]:
        x = chip_smoke._rand(rs, b, h, w, c)
        wt = chip_smoke._rand(rs, c, 1, 7, 7, scale=1 / 7)
        bias = chip_smoke._rand(rs, c, scale=0.1)
        got, plain = depthwise_conv(x, wt, bias), depthwise_conv_plain(x, wt, bias)
        ref = depthwise_conv_plain(x.double().cpu(), wt.double().cpu(), bias.double().cpu()).cuda()
        ek, ep = (got - ref).abs(), (plain - ref).abs()
        out.append({'shape': (b, h, w, c), 'err': (got - plain).abs().max().item(),
                    'kernel_vs_f64': ek.max().item(), 'plain_vs_f64': ep.max().item(),
                    'kernel_off': int((ek > ATOL).sum()), 'plain_off': int((ep > ATOL).sum())})
    worst = max(r['err'] for r in out)
    bad = not worst <= ATOL
    print('BAD ' + json.dumps(out) if bad else f'ok {worst:.3e}', flush=True)
    return int(bad)


if __name__ == '__main__':
    sys.exit(main())
