"""What decides ``correct``: the stems the timed calls returned, compared with
the plain reference on spans drawn from the seed.

For each item that the mix's ``checked`` picks among those the window
finished (the longest among them), every span that ``Mix.spans`` gave it
during the window is worked out again by the reference: the state dict made
again from the seed, the recording made again from the seed, the published
overlap-add demix evaluated on the chunks that touch the span, each chunk
through the f32 forward with TF32 off. Each stem is compared by its
relative error ||program − reference|| / ||reference|| over the span, the
instrumental against the recording less the reference's vocals; a number
is the worst span's. An item whose call raised, or returned stems of the
wrong names, shape or with a non-finite sample, makes every number infinite.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from h100_bench import weights
from h100_bench.reference import demix as ref_demix
from h100_bench.reference.roformer import F32


def instruments(config: dict) -> list:
    training = config.get("training", {}) or {}
    if training.get("target_instrument"):
        return [training["target_instrument"]]
    return list(training.get("instruments") or ["restored"])


def keep(out, mix: np.ndarray, names: list, spans, extract_instrumental: bool):
    """What the check needs of one call's output: its stems on the spans,
    or the reason it cannot be compared."""
    want = names + (["instrumental"] if extract_instrumental and "instrumental" not in names
                    else [])
    if sorted(out) != sorted(want):
        return {"problem": f"stems {sorted(out)}, expected {sorted(want)}"}
    for k in want:
        a = out[k]
        if not isinstance(a, np.ndarray) or a.shape != mix.shape:
            return {"problem": f"{k}: {type(a).__name__} {getattr(a, 'shape', None)}, "
                               f"expected numpy {mix.shape}"}
        if not np.isfinite(a).all():
            return {"problem": f"{k}: non-finite samples"}
    return {"spans": spans, "stems": {k: [out[k][:, lo:hi].copy() for lo, hi in spans]
                                      for k in want}}


def rel_err(prog: np.ndarray, ref: np.ndarray) -> float:
    return float(np.linalg.norm(prog.astype(np.float64) - ref) / max(np.linalg.norm(ref), 1e-30))


def compare(run, items: list) -> dict:
    """{number: worst relative error} over ``items`` (indices of run.kept)."""
    names = instruments(run.config)
    numbers = {f"{n}_rel_err": 0.0 for n in names}
    if run.extract_instrumental and "instrumental" not in names:
        numbers["instrumental_rel_err"] = 0.0
    if any("problem" in run.kept[i] for i in run.kept):
        return {k: math.inf for k in numbers}
    dev = run.device
    sd = weights.make_state_dict(run.model_mod.state_dict_layout(run.config["model"]),
                                 run.seed, dev)

    products = F32()

    def model(x: np.ndarray) -> np.ndarray:
        with products.context():
            y = run.model_mod.reference_forward(sd, run.config["model"],
                                                torch.as_tensor(x, device=dev), products)
        return y.cpu().numpy()

    for i in items:
        kept = run.kept[i]
        mix = run.mix.audio(i)
        ref = ref_demix.regions(model, mix, run.chunk, run.overlap, kept["spans"])
        for j, (lo, hi) in enumerate(kept["spans"]):
            stems = ref[(lo, hi)]
            for s, n in enumerate(names):
                numbers[f"{n}_rel_err"] = max(numbers[f"{n}_rel_err"],
                                              rel_err(kept["stems"][n][j], stems[s]))
            if "instrumental_rel_err" in numbers and "instrumental" not in names:
                # the session's instrumental: the mix less its vocals (or first stem)
                voc = names.index("vocals") if "vocals" in names else 0
                inst = mix[:, lo:hi].astype(np.float64) - stems[voc]
                numbers["instrumental_rel_err"] = max(
                    numbers["instrumental_rel_err"],
                    rel_err(kept["stems"]["instrumental"][j], inst))
    return numbers
