#!/usr/bin/env python3
"""Where K11 `position_events` spends its time, stage by stage, on one GPU.

    python3 -m elasticsearch_tpu_torch.tools.k11_profile [--scale S]

Builds one row shaped like the widest phrase of the one-shard cfg2 corpus
(a head-term pair: two sorted runs of ~40.5 M positions over 8,841,823
docs, positions below 60, a worklist of 524,288 tiles with shifts 0 and
1), checks K11 against its plain version on it (exact), times K11 and
`torch.sort` over the same packed keys (CUDA-event mean of back-to-back
calls), and sums each of K11's CUDA kernels' device time over three
calls with torch.profiler. `--scale` divides the sizes. Prints one JSON
line and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def _ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--scale", type=int, default=1)
    args = parser.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..ops import kernels as K

    if not torch.cuda.is_available():
        print("k11_profile: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    num_docs = 8841823 // args.scale
    run = 40_500_000 // args.scale // 256 * 256
    nt = 524288 // args.scale
    half = nt // 2
    pt = run // 256 + half + 8
    g = torch.Generator(device=dev).manual_seed(0)
    pos_doc = torch.sort(torch.randint(0, num_docs, (pt * 256,), device=dev,
                                       generator=g)).values
    pos_doc = pos_doc.to(torch.int32).reshape(pt, 256)
    pos_val = torch.randint(0, 60, (pt, 256), device=dev, generator=g,
                            dtype=torch.int32)

    def i32(*parts):
        return torch.cat(parts).to(torch.int32)[None]

    zeros = torch.zeros(half, dtype=torch.int64, device=dev)
    tiles = torch.arange(half, device=dev)
    second = (run // 256) * 256
    call = (pos_doc, pos_val, i32(tiles, tiles + run // 256),
            i32(zeros, zeros + second), i32(zeros + run, zeros + second + run),
            i32(zeros, zeros + 1), num_docs, 6, 0, K.EVENTS_PHRASE)
    got = K.position_events(*call)
    want = K.position_events_plain(*call)
    torch.cuda.synchronize()
    equal = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
    unsorted, _valid = K.event_keys(*call)
    out = {
        "lanes": nt * 256,
        "events": int(got[1][0]),
        "equal_to_plain": equal,
        "k11_ms": _ms(lambda: K.position_events(*call)),
        "torch_sort_ms": _ms(lambda: torch.sort(unsorted, dim=1)),
    }
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            K.position_events(*call)
        torch.cuda.synchronize()
    stages = {}
    for ev in prof.key_averages():
        if ev.key.startswith("events_"):
            name = ev.key.split("(")[0]
            total_us = getattr(ev, "device_time_total",
                               getattr(ev, "cuda_time_total", 0.0))
            stages[name] = {"device_ms_per_call": total_us / 3e3,
                            "launches_per_call": ev.count / 3}
    out["stages"] = stages
    print(json.dumps(out))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    print(smi.stdout.strip() or "unknown")
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
