"""Tiny sizes for CPU runs of the harness: the cells' configurations at a
fraction of their widths, depth 1, one-second chunks, short items, f32."""

SESSION = {"batch_size": 2, "num_overlap": 2, "compute_dtype": "f32", "transport": "f32",
           "use_tta": False, "extract_instrumental": True}


def overrides(lengths=(3, 9), check_items=2, **session):
    return {"model.dim": 32, "model.depth": 1, "model.heads": 2, "model.dim_head": 16,
            "audio.chunk_size": 44100, "traffic.length_s": list(lengths),
            "traffic.check_items": check_items, "traffic.motifs": 4,
            "traffic.session": dict(SESSION, **session)}
