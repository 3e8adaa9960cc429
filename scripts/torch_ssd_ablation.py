"""Where the ``mamba2_ssd`` kernels spend their time, on one CUDA card:
each part of ``csrc/mamba2_ssd.cu`` left out in turn.

The card's profilers (ncu, nsys) do not run on the machine with the
card, so this builds variants of the source, each with one part cut out,
and takes every CUDA kernel's device time from ``torch.profiler`` at
``chip_smoke.py``'s phase-11 shapes (mamba2's and jamba's prefills,
bf16).  A variant computes a wrong y; only its time is read.  What a cut
saves is an upper bound of that part's cost: the parts overlap in time.

    PYTHONPATH=src python3 scripts/torch_ssd_ablation.py

Each variant names the text it cuts; the script fails if the source no
longer holds that text.  Libraries go to ``src/repro_torch/_build/``.
"""

from __future__ import annotations

import ctypes
import importlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.append(str(ROOT / "src"))

# (S, nh, ds) at head dim 64, one B/C group: phase 11's timed shapes
SHAPES = {"mamba2 prefill S=2048": (2048, 32, 128),
          "jamba S=2000": (2000, 128, 16)}
KERNELS = ("ssd_chunk_kernel", "ssd_scan_kernel", "ssd_output_kernel")


def cut(src: str, start: str, end: str = None, keep: str = "") -> str:
    """src with the text from ``start`` up to ``end`` (or ``start`` alone)
    replaced by ``keep``."""
    i = src.index(start)
    j = src.index(end, i) if end else i + len(start)
    return src[:i] + keep + src[j:]


def variants(src: str):
    out_loads = "  load_tile<T, LX>(xs, x + (((size_t)b * S + t0) * nh + h) * hd + p0"
    out_cum = "  chunk_cum(dt + ((size_t)b * S + t0) * nh + h, nh, n, A[h], cum, dts, wsum);\n\n"
    inter = src.index("    for (int ks = 0; ks < DS; ks += 16) {",
                      src.index("ssd_output_kernel("))
    return {
        "all parts": src,
        "output: no W x": cut(src, "const int nks = (i0 + 16 * warp + 16) / 16;",
                              keep="const int nks = 0;"),
        "output: no (C h^T)": src[:inter] + "    for (int ks = 0; ks < 0; ks += 16) {"
        + src[inter + len("    for (int ks = 0; ks < DS; ks += 16) {"):],
        "output: no y stores": cut(
            src, "        *reinterpret_cast<uint32_t*>(yb + (size_t)i * x_row + col)",
            keep="        if (y0 == 1234.5f && y1 == -7.f)\n"
                 "          *reinterpret_cast<uint32_t*>(yb + (size_t)i * x_row + col)"),
        "output: no x, C, h loads": cut(src, out_loads, "  mma::cp_async_commit();\n  "
                                        "mma::cp_async_wait<0>();\n  chunk_cum"),
        "output: no scan of cum": cut(src, out_cum, keep="  __syncthreads();\n\n"),
        "chunk: no state products": cut(src, "    for (int ks = 0; ks < kQ; ks += 16) {",
                                        keep="    for (int ks = 0; ks < 0; ks += 16) {"),
        "chunk: no x, B loads": cut(src, "  load_tile<T, L::kLdX>(xs, x + ",
                                    "  mma::cp_async_commit();\n  chunk_cum("),
    }


def build_all(build, texts):
    """One library per variant, compiled in parallel; name -> launch fn."""
    out = build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        src = out / f"ssd_{i}.cu"
        src.write_text(text)
        lib = out / f"libssd_{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc(), *flags, "-I", str(build.CSRC), "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
        fn = ctypes.CDLL(str(lib)).mamba2_ssd_launch
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("torch_ssd_ablation: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    ssd = importlib.import_module("repro_torch.kernels.mamba2_ssd")
    fns = build_all(build, variants((build.CSRC / "mamba2_ssd.cu")
                                    .read_text()))
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(7)
    for label, (S, nh, ds) in SHAPES.items():
        x = (torch.randn((1, S, nh, 64), generator=g, device="cuda") * 0.5
             ).to(torch.bfloat16)
        dt = F.softplus(torch.randn((1, S, nh), generator=g, device="cuda"))
        A = -torch.linspace(1.0, 16.0, nh, device="cuda")
        Bm, Cm = ((torch.randn((1, S, 1, ds), generator=g, device="cuda")
                   * 0.5).to(torch.bfloat16) for _ in range(2))
        nc = -(-S // ssd.CHUNK)
        y = torch.empty_like(x)
        state = torch.empty((1, nh, 64, ds), device="cuda")
        scratch = torch.empty(nc * ssd.CHUNK ** 2 + nh * nc * (64 * ds + 1),
                              device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        print(f"{label} (nh={nh} ds={ds}): device ms a call of each kernel")
        for name, fn in fns.items():
            fn.argtypes = ssd._ARGS

            def call():
                err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                         Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                         state.data_ptr(), scratch.data_ptr(), 1, S, nh, 64,
                         1, ds, 1, stream)
                assert err == 0, f"{name}: launch error {err}"
            call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    flush.zero_()
                    call()
                torch.cuda.synchronize()
            ms = {k: sum(e.self_device_time_total / e.count
                         for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA and k in e.key)
                  / 1e3 for k in KERNELS}
            print(f"  {name:26s}" + "  ".join(
                f"{k.split('_')[1]} {v:.4f}" for k, v in ms.items())
                + f"  total {sum(ms.values()):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
