"""nvcc of csrc/fused_mlp.cu with and without `--split-compile=0`, on the
GPU machine: each build's seconds and ptxas register / spill report, then
every mode of the fused MLP (3xTF32, one and three bf16 passes) from both
libraries on the three NICE decoders at 262,157 points, compared bit for
bit.

    python scripts/port_split_compile_probe.py

Prints the nvcc version, one report per build, then `BIT_EQUAL True` or
`False`; exits 1 when a build fails or the outputs differ.  The libraries
go to build/ under names of their own.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    import torch
    from nice_slam_tpu_torch.models.decoders import (
        DecoderConfig, init_nice_decoders)
    from nice_slam_tpu_torch.ops import build as B
    from nice_slam_tpu_torch.ops import fused_mlp as fm
    if not torch.cuda.is_available():
        print('port_split_compile_probe: no CUDA device', file=sys.stderr)
        return 2
    print(subprocess.run([B._nvcc(), '--version'], capture_output=True,
                         text=True).stdout.strip().splitlines()[-1])
    os.makedirs(B.BUILD_DIR, exist_ok=True)
    libs = {}
    for name, extra in (('plain', []), ('split', ['--split-compile=0'])):
        out = os.path.join(B.BUILD_DIR, f'libnst_fused_mlp_{name}.so')
        t0 = time.perf_counter()
        res = subprocess.run(
            [B._nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
             '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
             '-Xptxas', '-v', *extra, '-o', out, fm.SOURCE],
            capture_output=True, text=True)
        print(name, 'rc', res.returncode, 'seconds',
              round(time.perf_counter() - t0, 1))
        if res.returncode != 0:
            print(res.stderr[-3000:])
            return 1
        print('\n'.join(l for l in res.stderr.splitlines()
                        if 'registers' in l or 'spill' in l))
        libs[name] = out
    decs = init_nice_decoders(DecoderConfig(),
                              generator=torch.Generator().manual_seed(3),
                              device='cpu').to('cuda')
    outs = {}
    for name, path in libs.items():
        # the wrapper bound to this library (no rebuild from the source)
        fm._lib, fm.LIBRARY = None, path
        fm._KERNEL_PACK_SIZES.clear()
        fm.is_stale = lambda source, library: False
        outs[name] = []
        for dec, c_dim, color in (('middle', 32, False), ('fine', 64, False),
                                  ('color', 32, True)):
            gen = torch.Generator(device='cuda').manual_seed(7)
            p = torch.rand((262157, 3), generator=gen, device='cuda') * 4 - 2
            c = torch.randn((262157, c_dim), generator=gen, device='cuda')
            params = [w.detach() for w in fm.mlp_params(decs[dec])]
            for prec in (None, 'bfloat16', 'tensorfloat32'):
                outs[name].append(fm.fused_mlp_forward(
                    p, c, params, color=color, precision=prec).cpu())
    same = all(torch.equal(a, b) for a, b in zip(outs['plain'],
                                                 outs['split']))
    print('BIT_EQUAL', same)
    return 0 if same else 1


if __name__ == '__main__':
    sys.exit(main())
