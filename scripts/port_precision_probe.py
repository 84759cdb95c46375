"""A probe of the bfloat16 products behind model.decoder_matmul_precision
(nice_slam_tpu_torch/models/precision.py) on one GPU.

    python scripts/port_precision_probe.py

1. Accuracy of `torch.mm(a_bf16, b_bf16, out_dtype=float32)` against a
   float64 product of the same bf16 values, as the rms error relative to
   the reference's rms, for a weight gradient X^T.G ([K, 256] each, K the
   rows summed) in three layouts: X^T as a transposed view (a), the
   operands swapped, (G^T.X)^T (b), and X^T as a contiguous copy (c); then
   (d) the plain version (float32 product of the bf16 values).  Then the
   forward shapes [M, 256] @ [256, 256]^T and [M, 3] @ [3, 93] at odd M.
   Under both cuBLAS back ends (`preferred_blas_library`) and both values
   of `allow_bf16_reduced_precision_reduction`.
2. Host cost: microseconds a call launched back to back (host) and with a
   synchronize after the loop (host + device), of a float32 torch.mm, the
   bf16 product with a float32 and with a bf16 output, the rounding to
   bf16, and one forward + backward of `precision.linear` at float32 and
   bfloat16, at 44,000 and 220,000 rows.
3. A sweep of the weight gradient's row count K (4,088-4,209, 8,180-8,199,
   16,376-16,399, 2^n - 8 ... 2^n + 8 for n = 6-18, 150 drawn below
   400,000; 256, 4 and 93 columns) in three forms: X^T as a transposed view,
   the rows padded with zeros to a multiple of 8, X^T as a contiguous copy;
   the counts whose rms error passes 16 sqrt(K) 2^-24 of the reference's,
   and the worst error over that bound.

Prints one line per case; the first line is torch's version and the cuBLAS
back end by default.
"""
import json
import os
import random
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nice_slam_tpu_torch.models import precision as P  # noqa: E402


def rel(got, ref):
    return float((got.double() - ref).pow(2).mean().sqrt()
                 / ref.pow(2).mean().sqrt())


def host_us(fn, n=200):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return round((t1 - t0) / n * 1e6, 1), round((t2 - t0) / n * 1e6, 1)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = 'cuda'
    print(torch.__version__, torch.backends.cuda.preferred_blas_library(),
          flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    for lib in ('cublas', 'cublaslt'):
        torch.backends.cuda.preferred_blas_library(lib)
        for red in (True, False):
            torch.backends.cuda.matmul.\
                allow_bf16_reduced_precision_reduction = red
            for k in (1000, 4096, 4097, 4100, 4104, 4112, 4160, 8191, 44000,
                      44001, 65536, 65537, 220000, 380000, 380003):
                x = torch.randn(k, 256, generator=g, device=dev).bfloat16()
                gg = torch.randn(k, 256, generator=g, device=dev).bfloat16()
                ref = x.double().t() @ gg.double()
                f32 = torch.float32
                a = rel(torch.mm(x.t(), gg, out_dtype=f32), ref)
                b = rel(torch.mm(gg.t(), x, out_dtype=f32).t(), ref)
                c = rel(torch.mm(x.t().contiguous(), gg, out_dtype=f32), ref)
                d = rel(x.float().t() @ gg.float(), ref)
                print(lib, red, k, '%.2e %.2e %.2e %.2e' % (a, b, c, d),
                      flush=True)
            for m in (4097, 65537, 380003):
                x = torch.randn(m, 256, generator=g, device=dev).bfloat16()
                w = torch.randn(256, 256, generator=g, device=dev).bfloat16()
                print(lib, red, 'fwd', m, '%.2e' % rel(
                    torch.mm(x, w.t(), out_dtype=torch.float32),
                    x.double() @ w.double().t()), flush=True)
                p = torch.randn(m, 3, generator=g, device=dev).bfloat16()
                bm = torch.randn(3, 93, generator=g, device=dev).bfloat16()
                print(lib, red, 'emb', m, '%.2e' % rel(
                    torch.mm(p, bm, out_dtype=torch.float32),
                    p.double() @ bm.double()), flush=True)
    torch.backends.cuda.preferred_blas_library('cublas')
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    for lib in ('cublas', 'cublaslt'):
        torch.backends.cuda.preferred_blas_library(lib)
        for m in (44000, 220000):
            x = torch.randn(m, 256, generator=g, device=dev)
            w = torch.randn(256, 256, generator=g, device=dev)
            xb, wb = x.bfloat16(), w.bfloat16()
            b = torch.randn(256, generator=g, device=dev)
            gg = torch.randn(m, 256, generator=g, device=dev)
            xl, wl, bl = (t.clone().requires_grad_() for t in (x, w, b))

            def fb(prec):
                def f():
                    xl.grad = wl.grad = bl.grad = None
                    P.linear(xl, wl, bl, prec).backward(gg)
                return f
            print(lib, m, json.dumps({
                'f32_mm (host us, synced us)': host_us(lambda: x @ w),
                'mm_dtype': host_us(
                    lambda: torch.mm(xb, wb, out_dtype=torch.float32)),
                'mm_bf16_out': host_us(lambda: xb @ wb),
                'to_bf16': host_us(lambda: x.to(torch.bfloat16)),
                'linear_fb_f32': host_us(fb(None), 50),
                'linear_fb_bf16': host_us(fb('bfloat16'), 50)}), flush=True)
    torch.backends.cuda.preferred_blas_library('cublas')
    sweep(dev)


def sweep(dev) -> None:
    g = torch.Generator(device=dev).manual_seed(1)
    ks = set(range(4088, 4210)) | set(range(8180, 8200)) \
        | set(range(16376, 16400))
    for n in range(6, 19):
        for d in range(-8, 9):
            ks.add(2 ** n + d)
    rng = random.Random(0)
    ks |= {rng.randrange(10, 400000) for _ in range(150)}
    ks = sorted(k for k in ks if k > 0)
    bad = {'view': [], 'pad8': [], 'copy': []}
    worst = {'view': 0.0, 'pad8': 0.0, 'copy': 0.0}
    for n_out in (256, 4, 93):
        for k in ks:
            x = torch.randn(k, 256, generator=g, device=dev).bfloat16()
            gg = torch.randn(k, n_out, generator=g, device=dev).bfloat16()
            ref = x.double().t() @ gg.double()
            tol = 16 * k ** 0.5 * 2.0 ** -24
            p = (-k) % 8
            xp = torch.nn.functional.pad(x, (0, 0, 0, p)) if p else x
            gp = torch.nn.functional.pad(gg, (0, 0, 0, p)) if p else gg
            f32 = torch.float32
            for name, got in (
                    ('view', torch.mm(x.t(), gg, out_dtype=f32)),
                    ('pad8', torch.mm(xp.t(), gp, out_dtype=f32)),
                    ('copy', torch.mm(x.t().contiguous(), gg,
                                      out_dtype=f32))):
                r = rel(got, ref)
                worst[name] = max(worst[name], r / tol)
                if r > tol:
                    bad[name].append((n_out, k, r))
        print(n_out, 'checked', len(ks), {k: len(v) for k, v in bad.items()},
              flush=True)
    print('worst error / (16 sqrt(K) 2^-24):', worst)
    for k, v in bad.items():
        print(k, v[:40])


if __name__ == '__main__':
    main()
