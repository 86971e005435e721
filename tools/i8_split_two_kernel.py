"""Time the two stages of the two-kernel I8 apart on one NVIDIA GPU.

The I8 of ``csrc/int8_attention.cu`` up to its redesign ran two kernels in
one C call (``sesa_int8_attn``): ``quantise_kernel`` (the k mean and the int8
codes and scales of q and of k less its mean, one block per sequence) and
``attention_kernel`` (mma.sync over cp.async key tiles, two passes). One C
call cannot be split by CUDA events, so this script compiles that tree's
source with two more entry points appended, one per kernel, and times each
with CUDA events at the flagship's two legs (time: 372 x 8 sequences of 690
frames; freq: 4140 x 8 of 62 bands; dim_head 64), on the views the roformer
hands it (``chip_smoke._k3_views``). It checks that the two stages in turn
give the tree's own ``sdpa_int8`` output bit for bit, and times the tree's
whole call and SDPA's fastest backend beside them.

    mkdir chip_parent; git archive <commit> | tar -x -C chip_parent
    python3 tools/i8_split_two_kernel.py --tree chip_parent

Prints one JSON object per leg and the card's name and power limit, and
writes them to chiprun_out/i8_split_two_kernel.json.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHIM = r"""
extern "C" int i8split_quantise(const void* q, const void* k, void* q8, void* k8, void* qs,
                                void* ks, long long qb, long long qh, long long qs_,
                                long long kb, long long kh, long long ks_, int batch,
                                int heads, int n, int d, void* stream) {
  const Strides sq = {qb, qh, qs_}, sk = {kb, kh, ks_};
  quantise_kernel<64><<<(unsigned)((long long)batch * heads), 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, sq, sk, heads, n, d, (int8_t*)q8, (int8_t*)k8,
      (float*)qs, (float*)ks);
  return (int)cudaGetLastError();
}

extern "C" int i8split_attention(const void* v, void* o, const void* q8, const void* k8,
                                 const void* qs, const void* ks, long long vb, long long vh,
                                 long long vs, int batch, int heads, int n, int d, float scale,
                                 void* stream) {
  const Strides sv = {vb, vh, vs};
  const int qtiles = (n + BQ - 1) / BQ;
  constexpr int smem = Smem<64>::TOTAL;
  cudaFuncSetAttribute(attention_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  attention_kernel<64><<<(unsigned)((long long)batch * heads * qtiles), THREADS, smem,
                         (cudaStream_t)stream>>>(
      (const int8_t*)q8, (const int8_t*)k8, (const float*)qs, (const float*)ks,
      (const bf16*)v, sv, (bf16*)o, heads, n, d, qtiles, scale);
  return (int)cudaGetLastError();
}
"""


def build(tree: str, out_dir: str) -> ctypes.CDLL:
    csrc = os.path.join(os.path.abspath(tree), "sesa_tpu_torch", "csrc")
    with open(os.path.join(csrc, "int8_attention.cu")) as f:
        src = f.read()
    if "quantise_kernel" not in src or "attention_kernel" not in src:
        raise RuntimeError(f"{tree}: its int8_attention.cu is not the two-kernel form")
    path = os.path.join(out_dir, "i8_split.cu")
    with open(path, "w") as f:
        f.write(src + SHIM)
    lib_path = os.path.join(out_dir, "libi8_split.so")
    from sesa_tpu_torch.ops import _build

    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", lib_path, path],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    P, L, I, F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.i8split_quantise.argtypes = [P] * 6 + [L] * 6 + [I] * 4 + [P]
    lib.i8split_attention.argtypes = [P] * 6 + [L] * 3 + [I] * 4 + [F, P]
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", required=True, help="a tree whose I8 is the two-kernel form")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("i8_split_two_kernel: no CUDA device visible", file=sys.stderr)
        return 1
    import sesa_tpu_torch
    from sesa_tpu_torch.ops.attention import sdpa_int8

    if not os.path.abspath(sesa_tpu_torch.__file__).startswith(os.path.abspath(args.tree)):
        raise RuntimeError(f"imported {sesa_tpu_torch.__file__}, not the tree {args.tree}")
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(21)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(args.tree, tmp)
        stream = torch.cuda.current_stream(dev).cuda_stream
        heads, dh = cs.FLAGSHIP_MODEL["heads"], cs.FLAGSHIP_MODEL["dim_head"]
        for leg, b, n in (("time", cs.BATCH * cs.BANDS, cs.FRAMES),
                          ("freq", cs.BATCH * cs.FRAMES, cs.BANDS)):
            q, k, v = cs._k3_views(gen, dev, b, n, heads, dh)
            q8 = torch.empty((b * heads * n * dh,), dtype=torch.int8, device=dev)
            k8 = torch.empty_like(q8)
            qs = torch.empty((b * heads * n,), dtype=torch.float32, device=dev)
            ks = torch.empty_like(qs)
            o = torch.empty((b, heads, n, dh), dtype=torch.bfloat16, device=dev)
            st = lambda t: (t.stride(0), t.stride(1), t.stride(2))  # noqa: E731

            def quantise():
                rc = lib.i8split_quantise(q.data_ptr(), k.data_ptr(), q8.data_ptr(),
                                          k8.data_ptr(), qs.data_ptr(), ks.data_ptr(), *st(q),
                                          *st(k), b, heads, n, dh, stream)
                if rc:
                    raise RuntimeError(f"i8split_quantise: CUDA error {rc}")

            def attention():
                rc = lib.i8split_attention(v.data_ptr(), o.data_ptr(), q8.data_ptr(),
                                           k8.data_ptr(), qs.data_ptr(), ks.data_ptr(), *st(v),
                                           b, heads, n, dh, dh ** -0.5, stream)
                if rc:
                    raise RuntimeError(f"i8split_attention: CUDA error {rc}")

            quantise()
            attention()
            whole = sdpa_int8(q, k, v)
            torch.cuda.synchronize()
            if not torch.equal(o, whole):
                raise RuntimeError(f"{leg} leg: the two stages differ from the tree's sdpa_int8")
            row = dict(leg=leg, bh=b * heads, n=n, dh=dh,
                       quantise_ms=cs.time_ms(quantise, reps=20, warmup=3),
                       attention_ms=cs.time_ms(attention, reps=20, warmup=3),
                       whole_ms=cs.time_ms(lambda: sdpa_int8(q, k, v), reps=20, warmup=3))
            row.update(cs.k3_library(q, k, v, dh ** -0.5))
            print(json.dumps(row), flush=True)
            results.append(row)
            del q, k, v, q8, k8, qs, ks, o, whole
            torch.cuda.empty_cache()
    card = cs.gpu_line()
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "i8_split_two_kernel.json"), "w") as f:
        json.dump(dict(card=card, tree=args.tree, legs=results), f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
