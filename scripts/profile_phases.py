#!/usr/bin/env python
"""Profile the ref roundtrip and the ref gl2 GEMM + relinearize on one GPU.

    python scripts/profile_phases.py [--out DIR] [--top N]

1. Times the ref roundtrip with fast_float off and on, in turns (off, on,
   on, off, ...), each call fenced with block_until_ready, and prints both
   medians.
2. Traces a few steady calls of each phase with jax.profiler and prints,
   for every line of the GPU plane, the top events by summed device time,
   the device's busy share of the traced window, and each jitted program's
   bytes accessed (XLA cost analysis) against its device time.

Traces are written under DIR (default .cache/trace).  Fails without a GPU.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time
from collections import defaultdict

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet


def log(msg: str) -> None:
    print(msg, flush=True)


def fast_float_ab(pairs: int = 4) -> None:
    import jax
    import jax.numpy as jnp

    import chip_smoke
    from matrix_fhe.config import get_params
    from matrix_fhe.models.he import HEContext

    p = get_params("ref")
    re, im = chip_smoke._uniform_msgs(p)
    rej, imj = jnp.asarray(re), jnp.asarray(im)
    ctxs = {ff: HEContext(p, fast_float=ff) for ff in (False, True)}
    sk = ctxs[False].generate_secret_key()
    times = {False: [], True: []}
    for ff, ctx in ctxs.items():
        (dr, di), first_s = chip_smoke.first_call(ctx.roundtrip, rej, imj, sk)
        err = float(np.hypot(np.asarray(dr) - re, np.asarray(di) - im).max())
        log(f"[fast_float={ff}] compile+first call {first_s:.3f} s, "
            f"max |err| {err!r}")
    for i in range(pairs):
        order = (False, True) if i % 2 == 0 else (True, False)
        for ff in order + order[::-1]:
            t0 = time.perf_counter()
            jax.block_until_ready(ctxs[ff].roundtrip(rej, imj, sk))
            times[ff].append(time.perf_counter() - t0)
    for ff in (False, True):
        t = np.asarray(times[ff]) * 1e3
        log(f"[fast_float={ff}] ref roundtrip median {np.median(t)!r} ms "
            f"(min {t.min()!r}, max {t.max()!r}, n={t.size})")


def reduce_trace(logdir: str, top: int) -> None:
    """Top events per line of each GPU plane, and the busy share."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        intervals = []
        for line in plane.lines:
            tot = defaultdict(float)
            cnt = defaultdict(int)
            stats = {}
            for ev in line.events:
                tot[ev.name] += ev.duration_ns
                cnt[ev.name] += 1
                if ev.name not in stats:
                    stats[ev.name] = {k: v for k, v in ev.stats}
                if line.name.startswith("Stream"):
                    intervals.append((ev.start_ns, ev.end_ns))
            total = sum(tot.values())
            if total <= 0:
                continue
            log(f"  [{plane.name} | {line.name}] {len(tot)} distinct, "
                f"{total / 1e6:.3f} ms summed")
            for name, ns in sorted(tot.items(), key=lambda kv: -kv[1])[:top]:
                st = {k: v for k, v in stats[name].items()
                      if "byte" in k or "flop" in k}
                log(f"    {ns / 1e6:10.3f} ms {ns / total:6.1%} x{cnt[name]:<4d}"
                    f" {name[:110]} {st if st else ''}")
        if intervals:
            intervals.sort()
            busy, cur_s, cur_e = 0.0, *intervals[0]
            for s, e in intervals[1:]:
                if s > cur_e:
                    busy += cur_e - cur_s
                    cur_s, cur_e = s, e
                else:
                    cur_e = max(cur_e, e)
            busy += cur_e - cur_s
            window = max(e for _, e in intervals) - intervals[0][0]
            log(f"  [{plane.name}] busy {busy / 1e6:.3f} ms of a "
                f"{window / 1e6:.3f} ms window: idle share "
                f"{1 - busy / window:.3f}")


def bytes_line(tag: str, fn, args, seconds: float) -> None:
    ca = fn.lower(*args).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    b = float(ca.get("bytes accessed", 0.0))
    log(f"[{tag}] XLA cost analysis: {b:.4g} bytes accessed, "
        f"{float(ca.get('flops', 0.0)):.4g} flops; at the measured "
        f"{seconds * 1e3:.3f} ms that is {b / seconds / 1e9:.1f} GB/s = "
        f"{b / seconds / HBM_BYTES_PER_S:.1%} of 3.35 TB/s")


def trace_phases(out: str, top: int) -> None:
    import jax
    import jax.numpy as jnp

    import chip_smoke
    from matrix_fhe import init_he_backend
    from matrix_fhe.config import get_params
    from matrix_fhe.utils.profiler import trace
    from matrix_fhe.utils.timer import benchmark

    p = get_params("ref")
    ctx = init_he_backend("ref")
    sk = ctx.generate_secret_key()
    re, im = chip_smoke._uniform_msgs(p)
    rej, imj = jnp.asarray(re), jnp.asarray(im)
    sec = benchmark(ctx.roundtrip, rej, imj, sk, iters=5, warmup=2)
    bytes_line("roundtrip ref", *ctx.roundtrip_program(rej, imj, sk), sec)
    d = os.path.join(out, "roundtrip")
    with trace(d):
        for _ in range(3):
            jax.block_until_ready(ctx.roundtrip(rej, imj, sk))
    log(f"[trace roundtrip ref] 3 calls")
    reduce_trace(d, top)

    _, g2, hm, gr, _, ks, _, _, _, ctX, ctY = chip_smoke._gl2_setup("ref")
    sec = benchmark(hm.matmul_tensor, ctX, ctY, iters=3, warmup=1)
    bytes_line("gl2 tensor ref", hm._tensor_jit, (ctX, ctY), sec)
    jax.block_until_ready(gr.matmul(ctX, ctY, ks))
    d = os.path.join(out, "gl2")
    with trace(d):
        for _ in range(2):
            jax.block_until_ready(gr.matmul(ctX, ctY, ks))
    log(f"[trace gl2 gemm+relin ref] 2 calls")
    reduce_trace(d, top)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, ".cache", "trace"))
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    from matrix_fhe.utils.device import card_info, require_gpu

    log(f"[device] JAX {require_gpu()}; {card_info()}")
    fast_float_ab()
    trace_phases(args.out, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
