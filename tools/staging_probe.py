"""upload_mix on the card: is the song bit-exact, does the call wait behind
the caller's queued work, and how long does the host spend in it.

    python3 tools/staging_probe.py [--tree DIR]

``--tree`` imports ``sesa_tpu_torch`` from another checkout (e.g. the parent
unpacked with ``git archive``), so two versions are timed on one card in one
call. For int16-exact stereo songs of 5 to 330 s (every sample n / 32768, as
decoded 16-bit PCM and the benchmark's traffic are) it prints, as one JSON
line: the host's time in ``upload_mix`` (median of 5, after a warm-up) and
the time until the copy is on the card; whether each upload equals
``torch.from_numpy(song).cuda()`` bit for bit, a transposed view included;
whether an upload made while a spin of about a second holds the caller's
stream returns before the spin ends, under
``torch.cuda.set_sync_debug_mode("error")``; and ``upload_stats()`` where the
tree has it. Exits 1 if a check fails.
"""

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
import time

SR = 44100
LENGTHS_S = (5, 20, 150, 240, 330)
SPIN_CYCLES = 2_000_000_000


def _song(seconds: float, seed: int):
    import numpy as np

    pcm = np.random.default_rng(seed).integers(-32768, 32768, (2, int(seconds * SR)))
    return (pcm.astype(np.float32) / 32768.0).astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=".", help="checkout whose sesa_tpu_torch is timed")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch

    from sesa_tpu_torch.runtime import upload_mix

    demix_mod = importlib.import_module("sesa_tpu_torch.runtime.demix")
    stats = getattr(demix_mod, "upload_stats", lambda: None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    res = {"tree": args.tree, "card": card, "stats_start": stats(), "lengths": {}}
    ok = True
    for i, seconds in enumerate(LENGTHS_S):
        song = _song(seconds, i)
        want = torch.from_numpy(song).cuda()
        upload_mix(song)  # warm-up: the ring's slots, the allocator's blocks
        torch.cuda.synchronize()
        host, whole, equal = [], [], True
        for _ in range(5):
            t0 = time.perf_counter()
            up = upload_mix(song)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            host.append((t1 - t0) * 1e3)
            whole.append((t2 - t0) * 1e3)
            equal = equal and torch.equal(up, want)
            del up
        ok = ok and equal
        res["lengths"][seconds] = {"host_ms": statistics.median(host),
                                   "to_card_ms": statistics.median(whole), "bit_exact": equal,
                                   "mb": song.nbytes / 1e6}
    song = _song(240, 99)
    transposed = np.ascontiguousarray(song.T).T
    res["transposed_bit_exact"] = bool(torch.equal(upload_mix(transposed),
                                                   torch.from_numpy(song).cuda()))
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        up = upload_mix(song)
        res["behind_spin_error"] = None
    except RuntimeError as e:  # a synchronising call under the debug mode
        up, res["behind_spin_error"] = None, str(e)[:200]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    res["behind_spin_host_ms"] = (time.perf_counter() - t0) * 1e3
    res["stream_busy_after_upload"] = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    res["behind_spin_bit_exact"] = up is not None and bool(
        torch.equal(up, torch.from_numpy(song).cuda()))
    res["stats_end"] = stats()
    ok = ok and res["transposed_bit_exact"] and res["behind_spin_bit_exact"]
    res["ok"] = ok
    print(json.dumps(res), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
