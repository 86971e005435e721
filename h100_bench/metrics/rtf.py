"""rtf (audio_s/s, host clock): audio seconds of every item the window
separated over the sum of their call walls (call to stems in host memory,
ended by a device synchronize)."""


def read(run):
    ok = [it for it in run.items if it["ok"]]
    walls = sum(it["wall_s"] for it in ok)
    return sum(it["audio_s"] for it in ok) / walls if walls > 0 else None
