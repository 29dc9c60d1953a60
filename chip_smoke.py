#!/usr/bin/env python
"""Smoke run of the Matrix-FHE main path on the GPU, at full reference width.

    python chip_smoke.py             # phases (a)-(c) on one card
    python chip_smoke.py --chips 4   # the sharded phases (d)-(f), four cards

Phases, each through the public entry points:

  (a) ref roundtrip: init_he_backend("ref") (n=64, phi=512, L=11),
      encode -> encrypt -> decrypt -> decode of uniform(-4, 4) messages
      (seed 7), max |err| < 1e-4 (the src/main.cu:150 contract).  Then at
      "mid": zero-noise decrypt(encrypt(m)) == m exactly, and the ciphertext
      words the GPU computes equal the same call placed on the CPU device.
  (b) gl2 homomorphic GEMM + relinearize at "ref" with the auto P basis:
      decrypt(Gl2GemmRelin.matmul) against Y^H X, within 2x the two-sided
      tensor baseline + 0.1.
  (c) four-step NTT at N=2^16, L=16 35-bit primes, B=128:
      inverse(forward(x)) == x, and forward on a slice of rows equals the
      CPU device bit for bit.
  (d) dp=4 ShardedPipeline ref roundtrip: each shard within 1e-4, and
      equal to the unsharded result bit for bit (the parity noise streams
      are deterministic, so this holds with the noise on).
  (e) coefficient-sharded DistFourStepNTT, N=2^17, L=16, B=16: equals the
      single-device FourStepNTT bit for bit.
  (f) W-sharded gl2 GEMM + relinearize at "ref", keys replicated: equals
      the unsharded ciphertext bit for bit.

Every phase prints its compile + first-call seconds, the median of steady
calls (each fenced with block_until_ready), the device's peak memory so far
and the compiled program's memory analysis.  Any failed check raises; the
last stdout line, printed only when every phase passed, is one JSON object
naming the device.  Without a GPU the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def first_call(fn, *args):
    """(result, seconds) of one call fenced with block_until_ready: the
    compile + first-call time when fn has not run on these shapes."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def report(tag: str, first_s: float, times, program=None) -> dict:
    """Print and return the phase's timing and memory lines.  `program` is
    (jitted function, args) to lower for compiled.memory_analysis()."""
    import jax

    med = float(np.median(times))
    log(f"[{tag}] compile+first call {first_s:.3f} s; steady median "
        f"{med * 1e3:.3f} ms over {len(times)} calls "
        f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f})")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[{tag}] peak_bytes_in_use (process so far) "
        f"{stats.get('peak_bytes_in_use')}")
    if program is not None:
        fn, args = program
        log(f"[{tag}] memory_analysis "
            f"{fn.lower(*args).compile().memory_analysis()}")
    return {"first_s": first_s, "median_s": med, "times_s": list(times)}


def _uniform_msgs(p, batch=()):
    rng = np.random.default_rng(7)
    shape = tuple(batch) + (p.phi, p.n, p.n)
    return rng.uniform(-4, 4, size=shape), rng.uniform(-4, 4, size=shape)


def _residues(p, seed: int):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, size=(p.phi, p.n, p.n),
                                  dtype=np.uint64) for q in p.moduli])


# -- (a) ----------------------------------------------------------------------

def phase_roundtrip(preset: str = "ref", tol: float = 1e-4,
                    iters: int = 5) -> dict:
    """init_he_backend(preset).roundtrip on the verify input; max |err|."""
    import jax.numpy as jnp

    from matrix_fhe import init_he_backend
    from matrix_fhe.config import get_params
    from matrix_fhe.utils.timer import time_calls

    p = get_params(preset)
    ctx = init_he_backend(preset)
    sk = ctx.generate_secret_key()
    re, im = _uniform_msgs(p)
    rej, imj = jnp.asarray(re), jnp.asarray(im)
    fast = ctx.batched_encoder.encoder.fast_float
    (dr, di), first_s = first_call(ctx.roundtrip, rej, imj, sk)
    err = float(np.hypot(np.asarray(dr) - re, np.asarray(di) - im).max())
    log(f"[roundtrip {preset}] fast_float={fast} max |err| {err!r} "
        f"(limit {tol})")
    check(err < tol, f"roundtrip max err {err} >= {tol}")
    times = time_calls(ctx.roundtrip, rej, imj, sk, iters=iters, warmup=0)
    out = report(f"roundtrip {preset}", first_s, times,
                 ctx.roundtrip_program(rej, imj, sk))
    out.update(err=err, fast_float=fast)
    return out


def phase_exact(preset: str = "mid") -> dict:
    """Zero-noise encrypt/decrypt identity, and GPU ciphertext words ==
    the same computation on the CPU device."""
    import jax
    import jax.numpy as jnp

    from matrix_fhe.config import get_params
    from matrix_fhe.models import rng as refrng
    from matrix_fhe.models.he import HEContext

    p = get_params(preset)
    cpu = jax.devices("cpu")[0]
    tag = f"exact {preset}"

    zctx = HEContext(p, zero_noise=True)
    sk = zctx.generate_secret_key()
    m = jnp.asarray(_residues(p, 11))
    ct = zctx.encrypt(m, sk)
    back = zctx.decrypt_to_eval(ct, sk)
    check(bool(jnp.array_equal(back, m)),
          "zero-noise decrypt(encrypt(m)) != m")
    log(f"[{tag}] zero-noise decrypt(encrypt(m)) == m: exact")
    ct_cpu = zctx.encrypt(jax.device_put(m, cpu), jax.device_put(sk, cpu))
    for name, g, c in (("b", ct.b, ct_cpu.b), ("a", ct.a, ct_cpu.a)):
        check(np.array_equal(np.asarray(g), np.asarray(c)),
              f"zero-noise ciphertext words {name}: device != CPU")
    log(f"[{tag}] zero-noise ciphertext words (b, a): device == CPU")

    # the reference-parity RNG streams, device against CPU
    gen_a = jax.jit(lambda: refrng.uniform_a(p))
    gen_e = jax.jit(lambda: refrng.gaussian_noise(p))
    a_dev, e_dev = gen_a(), gen_e()
    with jax.default_device(cpu):
        a_cpu, e_cpu = gen_a(), gen_e()
    check(np.array_equal(np.asarray(a_dev), np.asarray(a_cpu)),
          "uniform a stream: device != CPU")
    q = np.asarray(p.moduli, dtype=np.uint64).reshape(-1, 1, 1, 1)

    def centered(e):
        e = np.asarray(e)
        return np.where(e > q // 2, e.astype(np.int64) - q.astype(np.int64),
                        e.astype(np.int64))

    d = centered(e_dev) - centered(e_cpu)
    n_diff = int(np.count_nonzero(d))
    max_diff = int(np.abs(d).max())
    log(f"[{tag}] uniform a stream: device == CPU; gaussian e stream: "
        f"{n_diff} of {d.size} elements differ, max |diff| {max_diff}")

    # noisy encrypt on both devices from the device's streams: the integer
    # path is bit-exact whatever the streams
    nctx = HEContext(p)
    enc = jax.jit(lambda m_, sk_, a_, e_:
                  nctx._encrypt_core((m_,), sk_, a_, (e_,))[0])
    ct_dev = enc(m, sk, a_dev, e_dev)
    ct_c = enc(*(jax.device_put(v, cpu) for v in (m, sk, a_dev, e_dev)))
    for name, g, c in (("b", ct_dev.b, ct_c.b), ("a", ct_dev.a, ct_c.a)):
        check(np.array_equal(np.asarray(g), np.asarray(c)),
              f"noisy ciphertext words {name}: device != CPU")
    log(f"[{tag}] noisy ciphertext words from the device's streams: "
        f"device == CPU")
    return {"gaussian_n_diff": n_diff, "gaussian_max_diff": max_diff}


# -- (b) ----------------------------------------------------------------------

def _gl2_setup(preset: str):
    import jax
    import jax.numpy as jnp

    from matrix_fhe.config import get_params
    from matrix_fhe.models.he2 import Gl2Context
    from matrix_fhe.models.he_matmul2 import Gl2GemmRelin, HEMatmul2
    from matrix_fhe.models.keyswitch import RelinContext

    p = get_params(preset)
    ctx = Gl2Context(p)
    hm = HEMatmul2(ctx)
    gr = Gl2GemmRelin(hm, RelinContext(ctx, p_moduli="auto"))
    sk = ctx.generate_secret_key(jax.random.key(1))
    t0 = time.perf_counter()
    ks = jax.block_until_ready(gr.gen_keys(sk, jax.random.key(9)))
    keygen_s = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    W, n = p.phi, p.n
    X = rng.uniform(-1, 1, (W, n, n)) + 1j * rng.uniform(-1, 1, (W, n, n))
    Y = rng.uniform(-1, 1, (W, n, n)) + 1j * rng.uniform(-1, 1, (W, n, n))
    ctX = ctx.encrypt(ctx.encode(jnp.asarray(X.real), jnp.asarray(X.imag)),
                      sk, jax.random.key(2))
    ctY = ctx.encrypt(ctx.encode(jnp.asarray(Y.real), jnp.asarray(Y.imag)),
                      sk, jax.random.key(4))
    return p, ctx, hm, gr, sk, ks, keygen_s, X, Y, ctX, ctY


def phase_gl2(preset: str = "ref", iters: int = 5) -> dict:
    """Gl2GemmRelin.matmul at `preset` against the plaintext Y^H X."""
    import jax

    from matrix_fhe.utils.timer import time_calls

    tag = f"gl2 gemm+relin {preset}"
    p, ctx, hm, gr, sk, ks, keygen_s, X, Y, ctX, ctY = _gl2_setup(preset)
    rc = gr.rc
    key_bytes = sum(a.nbytes for a in jax.tree.leaves(ks))
    streamed = gr._use_streamed()
    log(f"[{tag}] Lqp={len(rc.qp_moduli)} (P widths "
        f"{[int(q).bit_length() for q in rc.p_moduli]}), dnum={rc.dnum}, "
        f"switch keys {key_bytes} bytes, keygen incl. compile "
        f"{keygen_s:.3f} s; relinearize path: "
        f"{'streamed, QP chunks ' + str(gr._qp_chunks()) if streamed else 'fused'}")
    ct_out, first_s = first_call(gr.matmul, ctX, ctY, ks)
    times = time_calls(gr.matmul, ctX, ctY, ks, iters=iters, warmup=0)
    out = report(tag, first_s, times, (hm._tensor_jit, (ctX, ctY)))

    d2 = float(p.delta) ** 2
    C = np.conj(np.swapaxes(Y, -1, -2)) @ X
    dr, di = ctx.decrypt_and_decode(ct_out, sk, delta_override=d2)
    err = float(np.hypot(np.asarray(dr) - C.real,
                         np.asarray(di) - C.imag).max())
    tt = hm.matmul_tensor(ctX, ctY)
    br, bi = ctx.decode(jax.jit(hm.decrypt_tensor_fn)(tt, sk),
                        delta_override=d2)
    base_err = float(np.hypot(np.asarray(br) - C.real,
                              np.asarray(bi) - C.imag).max())
    rel = err / float(np.abs(C).max())
    log(f"[{tag}] max |err| vs Y^H X (complex128) {err!r}, relative "
        f"{rel!r}; two-sided tensor baseline {base_err!r} "
        f"(limit 2*baseline + 0.1)")
    check(err < 2 * base_err + 0.1,
          f"gl2 GEMM err {err} >= 2*{base_err} + 0.1")
    out.update(err=err, rel_err=rel, base_err=base_err, streamed=streamed,
               key_bytes=key_bytes)
    return out


# -- (c) ----------------------------------------------------------------------

def _random_residues(primes, shape, seed: int):
    """[L, *shape] uniform residues, drawn on the default device."""
    import jax
    import jax.numpy as jnp

    keys = jax.random.split(jax.random.key(seed), len(primes))
    return jnp.stack([
        jax.random.randint(k, shape, 0, int(q), dtype=jnp.int64)
        .astype(jnp.uint64) for k, q in zip(keys, primes)])


def phase_ntt(log_n: int = 16, limbs: int = 16, bits: int = 35,
              batch: int = 128, iters: int = 5, cpu_rows: int = 2) -> dict:
    """FourStepNTT forward/inverse exactness and forward vs the CPU."""
    import jax
    import jax.numpy as jnp

    from matrix_fhe.ops.ntt_large import (FourStepNTT, FourStepPlan,
                                          generate_primes_1mod)
    from matrix_fhe.utils.timer import time_calls

    n = 1 << log_n
    tag = f"ntt N=2^{log_n} L={limbs} {bits}-bit B={batch}"
    primes = generate_primes_1mod(limbs, bits, 2 * n)
    ntt = FourStepNTT(FourStepPlan.make(n, primes))
    fwd, inv = jax.jit(ntt.forward), jax.jit(ntt.inverse)
    x = _random_residues(primes, (batch, n), 3)
    y, first_s = first_call(fwd, x)
    check(bool(jnp.array_equal(inv(y), x)), "inverse(forward(x)) != x")
    log(f"[{tag}] inverse(forward(x)) == x: exact")
    cpu = jax.devices("cpu")[0]
    y_cpu = fwd(jax.device_put(x[:, :cpu_rows], cpu))
    check(np.array_equal(np.asarray(y[:, :cpu_rows]), np.asarray(y_cpu)),
          "forward: device != CPU")
    log(f"[{tag}] forward on {cpu_rows} rows: device == CPU")
    times = time_calls(fwd, x, iters=iters, warmup=0)
    out = report(tag, first_s, times, (fwd, (x,)))
    rate = limbs * batch / out["median_s"]
    log(f"[{tag}] {rate!r} NTT/s (one NTT = one (limb, polynomial) pair)")
    out["ntt_per_s"] = rate
    return out


# -- (d)-(f): four devices ------------------------------------------------------

def phase_sharded_roundtrip(preset: str = "ref", n_dev: int = 4,
                            tol: float = 1e-4) -> dict:
    """dp-sharded ShardedPipeline roundtrip: per-shard error, and every
    shard equal to the unsharded program bit for bit.  The reference-parity
    noise streams are deterministic, so the bit-exact comparison holds with
    the noise on (it implies the zero-noise one)."""
    import jax
    import jax.numpy as jnp

    from matrix_fhe.config import get_params
    from matrix_fhe.models.he import HEContext
    from matrix_fhe.parallel import mesh as meshlib
    from matrix_fhe.parallel.pipeline import ShardedPipeline
    from matrix_fhe.utils.timer import time_calls

    tag = f"sharded roundtrip {preset} dp={n_dev}"
    p = get_params(preset)
    mesh = meshlib.make_mesh({"dp": n_dev, "tp": 1})
    re, im = _uniform_msgs(p, (n_dev,))
    rej, imj = jnp.asarray(re), jnp.asarray(im)
    ctx = HEContext(p)
    sk = ctx.generate_secret_key()
    sp = ShardedPipeline(ctx, mesh)
    (dr, di), first_s = first_call(sp.roundtrip, rej, imj, sk)
    errs = np.hypot(np.asarray(dr) - re, np.asarray(di) - im
                    ).reshape(n_dev, -1).max(axis=1)
    log(f"[{tag}] per-shard max |err| {errs.tolist()} (limit {tol})")
    check((errs < tol).all(), f"sharded roundtrip errors {errs}")
    times = time_calls(sp.roundtrip, rej, imj, sk, iters=3, warmup=0)
    out = report(tag, first_s, times)

    one = jax.jit(jax.vmap(ctx.roundtrip_fn, in_axes=(0, 0, None)))
    dev0 = jax.devices()[0]
    sk0 = jax.device_put(sk, dev0)
    for b in range(n_dev):
        wr, wi = one(*(jax.device_put(v[b:b + 1], dev0) for v in (rej, imj)),
                     sk0)
        check(np.array_equal(np.asarray(dr[b:b + 1]), np.asarray(wr))
              and np.array_equal(np.asarray(di[b:b + 1]), np.asarray(wi)),
              f"shard {b} != unsharded")
    log(f"[{tag}] every shard == unsharded, bit for bit")
    out["errs"] = errs.tolist()
    return out


def phase_dist_ntt(log_n: int = 17, limbs: int = 16, bits: int = 35,
                   batch: int = 16, n_dev: int = 4) -> dict:
    """Coefficient-sharded DistFourStepNTT vs single-device FourStepNTT."""
    import jax
    import jax.numpy as jnp

    from matrix_fhe.ops.ntt_large import FourStepPlan, generate_primes_1mod
    from matrix_fhe.parallel import mesh as meshlib
    from matrix_fhe.parallel.dist_ntt import DistFourStepNTT
    from matrix_fhe.utils.timer import time_calls

    n = 1 << log_n
    tag = f"dist ntt N=2^{log_n} L={limbs} B={batch} coeff={n_dev}"
    primes = generate_primes_1mod(limbs, bits, 2 * n)
    dist = DistFourStepNTT(FourStepPlan.make(n, primes),
                           meshlib.make_mesh({"coeff": n_dev}))
    x = _random_residues(primes, (batch, n), 5)
    want = jax.jit(dist.local.forward)(x)
    got, first_s = first_call(dist.forward, x)
    check(np.array_equal(np.asarray(got), np.asarray(want)),
          "sharded forward != single-device forward")
    check(bool(jnp.array_equal(dist.inverse(got), x)),
          "sharded inverse(forward(x)) != x")
    log(f"[{tag}] forward == single device, inverse(forward(x)) == x: "
        f"exact")
    times = time_calls(dist.forward, x, iters=5, warmup=0)
    return report(tag, first_s, times)


def phase_sharded_gl2(preset: str = "ref", n_dev: int = 4) -> dict:
    """W-sharded gl2 GEMM + relinearize (keys replicated) == unsharded."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from matrix_fhe.parallel import mesh as meshlib
    from matrix_fhe.utils.timer import time_calls

    tag = f"sharded gl2 gemm+relin {preset} tp={n_dev}"
    p, ctx, hm, gr, sk, ks, _, _, _, ctX, ctY = _gl2_setup(preset)
    want = jax.block_until_ready(gr.matmul(ctX, ctY, ks))
    mesh = meshlib.make_mesh({"tp": n_dev})
    lanes = NamedSharding(mesh, P(None, "tp", None, None))
    rep = NamedSharding(mesh, P())
    ctXs, ctYs = (jax.device_put(c, lanes) for c in (ctX, ctY))
    ks_r = jax.device_put(ks, rep)
    got, first_s = first_call(gr.matmul, ctXs, ctYs, ks_r)
    for name in ("b", "a"):
        check(np.array_equal(np.asarray(getattr(want, name)),
                             np.asarray(getattr(got, name))),
              f"sharded gl2 ciphertext {name} != unsharded")
    log(f"[{tag}] ciphertext (b, a) == unsharded, bit for bit")
    times = time_calls(gr.matmul, ctXs, ctYs, ks_r, iters=3, warmup=0)
    return report(tag, first_s, times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded phases, on four cards")
    args = ap.parse_args(argv)

    from matrix_fhe.utils.device import card_info, require_gpu

    dev = require_gpu()
    if dev["count"] < args.chips:
        raise SystemExit(f"--chips {args.chips} needs {args.chips} GPUs, "
                         f"JAX sees {dev['count']}")
    log(f"[device] JAX {dev}")
    t0 = time.perf_counter()
    if args.chips == 1:
        phase_roundtrip()
        phase_exact()
        phase_gl2()
        phase_ntt()
    else:
        phase_sharded_roundtrip(n_dev=args.chips)
        phase_dist_ntt(n_dev=args.chips)
        phase_sharded_gl2(n_dev=args.chips)
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    log(card_info())
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    # the CPU comparison device: keep the CPU backend beside the GPU when
    # the environment names the platforms
    _plats = os.environ.get("JAX_PLATFORMS")
    if _plats and "cpu" not in _plats.split(","):
        os.environ["JAX_PLATFORMS"] = _plats + ",cpu"
    sys.exit(main())
