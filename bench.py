#!/usr/bin/env python
"""Headline numbers on one GPU: N=2^16 negacyclic NTTs per second (RNS
L=16, 35-bit primes, B=128, ops/ntt_large.FourStepNTT) and the ref
encode -> encrypt -> decrypt -> decode roundtrip time.

    python bench.py

Each forward call transforms L*B independent (modulus, polynomial) pairs;
every pair is one N=2^16 negacyclic NTT.  Times are medians of calls fenced
with block_until_ready; compile time is reported apart as set-up.  Both
workloads carry their exactness checks (exact NTT roundtrip, roundtrip
error < 1e-4).  Prints the device, the card's name and power limit, then
ONE JSON line.  Fails without a GPU.
"""

import json
import sys

import chip_smoke


def main() -> int:
    from matrix_fhe.utils.device import card_info, require_gpu

    dev = require_gpu()
    ntt = chip_smoke.phase_ntt()
    rt = chip_smoke.phase_roundtrip()
    print(card_info(), flush=True)
    print(json.dumps({
        "metric": "NTTs/sec (N=2^16, L=16, negacyclic, 35-bit primes)",
        "value": ntt["ntt_per_s"],
        "unit": "NTT/s",
        "ntt_compile_first_s": ntt["first_s"],
        "ref_roundtrip_ms": rt["median_s"] * 1e3,
        "ref_roundtrip_compile_first_s": rt["first_s"],
        "ref_roundtrip_err": rt["err"],
        "device": dev,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
