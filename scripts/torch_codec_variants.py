"""Time the one-launch codec kernels (K1, K3, K4) against variants of their
source, in turns.

    python3 scripts/torch_codec_variants.py [--baseline OTHER.cu]

Builds ``bagua_tpu_torch/ops/csrc/codec.cu`` as it is and as each variant of
``VARIANTS`` (the same file with a line replaced: K1's slice held in shared
memory and K1's block size, K3's block size and loads in flight, choices the
source's notes say were settled by timing), plus, with ``--baseline``,
another version of the file (for example the parent commit's, written by
``git show`` into a directory ``.gitignore`` lists; a file whose K1 takes a
(tile, chunk) grid, or whose K3 is two kernels over partials, is called
through that older interface); one ``nvcc`` each, all started together.
Each build's registers and spills per kernel are printed; each build's K1,
K3 and K4 are held against the plain versions (payload bytes and sidecars
equal, K3's max equal, K4's scale within 1e-6) on a ragged case and the
path's chunk, then timed in the order A B ... B A, so that two versions are
compared on one card in one call: hot and with a cold L2, at the chunks of
``PERF.md``'s by-size table (K1 and K4 two chunks of 128 KiB, 1 MiB, 5 MiB
(the path's) and 8 MiB, f32; K3 one such chunk, as the ring's encode calls
it) and BERT-Large's embedding bucket chunk, beside K3's library call,
``torch.linalg.vector_norm(x, inf)``.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# name -> [(text in the source, replacement), ...]
VARIANTS = {
    # K1 holds nothing in shared memory: phase 2 reads its slice again from
    # device memory (L2 when it fits there), as the parent's second pass did
    "k1_reread": [("constexpr int kK1MaxSpans = 113;", "constexpr int kK1MaxSpans = 0;")],
    # K1 in blocks of 1024 threads (64 registers at most a thread)
    "k1_1024_threads": [("constexpr int kK1Threads = 512;", "constexpr int kK1Threads = 1024;")],
    # K3's shape: threads a block, loads a thread in flight, a block's least
    # share (loads a thread) and blocks an SM
    **{f"k3_t{t}_u{u}_l{l}_b{b}": [
        ("constexpr int kAbsmaxThreads = 512;", f"constexpr int kAbsmaxThreads = {t};"),
        ("constexpr int kAbsmaxInFlight = 8;", f"constexpr int kAbsmaxInFlight = {u};"),
        ("constexpr int kAbsmaxMinLoads = 8;", f"constexpr int kAbsmaxMinLoads = {l};"),
        ("constexpr int kAbsmaxBlocksPerSm = 4;", f"constexpr int kAbsmaxBlocksPerSm = {b};")]
       for t, u, l, b in ((512, 4, 4, 4), (512, 8, 4, 1), (512, 8, 16, 1), (256, 8, 4, 2))},
    # K3's ticket with release order only, and an acquire fence in the last
    # block alone
    "k3_release_ticket": [(
        "  if (atomic_add_acq_rel(&g_absmax_tickets[c], 1u) != (unsigned)blocks - 1) return;",
        "  unsigned int ticket;\n"
        "  asm volatile(\"atom.add.release.gpu.u32 %0, [%1], 1;\" : \"=r\"(ticket)"
        " : \"l\"(&g_absmax_tickets[c]) : \"memory\");\n"
        "  if (ticket != (unsigned)blocks - 1) return;\n"
        "  asm volatile(\"fence.acq_rel.gpu;\" ::: \"memory\");")],
}

N = 2
SIZES = {"128 KiB": 32768, "1 MiB": 262144, "5 MiB (path)": 1310720, "8 MiB": 2097152,
         "embedding chunk": 30522 * 1024 // N}


def variant_source(text, edits):
    """``text`` with each edit of a variant made."""
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{old!r} is not in the source")
        text = text.replace(old, new)
    return text


def start_build(name, source, out_dir):
    from bagua_tpu_torch.ops import _build

    src = out_dir / f"{name}.cu"
    src.write_text(source)
    return subprocess.Popen(_build.nvcc_command(src, out_dir / f"{name}.so"),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def bind(path, tiled, two_pass_k3):
    """The library at ``path``; ``tiled``: its K1 takes the (tile, chunk)
    grid's arguments (the interface before K1 became one launch);
    ``two_pass_k3``: its K3 takes the tiling and a partials scratch (before
    K3 became one launch)."""
    from bagua_tpu_torch.ops import codec as cd

    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    signatures = dict(cd._SIGNATURES)
    if tiled:
        signatures["bagua_minmax_compress"] = [p, i, i, q, q, i, p, p, p, p, p]
    if two_pass_k3:
        signatures["bagua_absmax"] = [p, i, i, q, q, i, p, p, p]
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def launchers(lib, tiled, one_launch_k4, two_pass_k3, x, n):
    """K1 and K4 of ``lib`` on ``x`` (n chunks) and K3 on its first chunk
    alone, each a function returning its CUDA error code, and their outputs;
    ``one_launch_k4``: K4 takes whole passes of a block a tile (else the
    two-kernel form's tiling)."""
    from bagua_tpu_torch.ops import codec as cd

    m = x.numel() // n
    bf = int(x.dtype == torch.bfloat16)
    mn = torch.empty(n, device="cuda")
    mx = torch.empty(n, device="cuda")
    payload = torch.empty((n, m), dtype=torch.uint8, device="cuda")
    nbytes = cd.sign_payload_bytes(m)
    if tiled:
        tile, tiles = cd._tiling(m)
        partials = torch.empty((n, tiles, 2), device="cuda")
    else:
        partials = torch.empty((n + cd._sm_count(x.device.index), 2), device="cuda")
    stile, stiles = (cd._sign_compress_tiling(nbytes, x.element_size()) if one_launch_k4
                     else cd._sign_tiling(nbytes))
    spartials = torch.empty((n, stiles), device="cuda")
    scale = torch.empty(n, device="cuda")
    spayload = torch.empty((n, nbytes), dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    d = lambda t: t.data_ptr()
    if tiled:
        k1 = lambda: lib.bagua_minmax_compress(d(x), bf, n, m, tile, tiles, d(partials), d(mn),
                                               d(mx), d(payload), stream)
    else:
        k1 = lambda: lib.bagua_minmax_compress(d(x), bf, n, m, d(partials), partials.shape[0],
                                               d(mn), d(mx), d(payload), stream)
    k4 = lambda: lib.bagua_sign_compress(d(x), bf, n, m, nbytes, stile, stiles, d(spartials),
                                         d(scale), d(spayload), stream)
    amax = torch.empty(1, device="cuda")
    if two_pass_k3:
        atile, atiles = cd._tiling(m)
        apartials = torch.empty(atiles, device="cuda")
        k3 = lambda: lib.bagua_absmax(d(x), bf, 1, m, atile, atiles, d(apartials), d(amax),
                                      stream)
    else:
        k3 = lambda: lib.bagua_absmax(d(x), bf, 1, m, d(amax), stream)
    return ({"k1": k1, "k3": k3, "k4": k4},
            {"k1": (mn, mx, payload), "k3": amax, "k4": (scale, spayload)})


def device_us(fn, calls=20):
    """Mean device duration of the kernels ``calls`` calls of ``fn`` run, in
    µs, from one profiler window after a warm-up (the kernel's body, without
    the launch between two kernels)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return statistics.fmean(spans) if spans else float("nan")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", type=Path, help="another codec.cu to time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from chip_smoke import PEAK_BYTES, cuda_ms, cuda_ms_cold, phase_device, ptxas_usage
    from bagua_tpu_torch.ops import _build, codec as cd

    print(phase_device(), flush=True)   # the card's name and power limit
    out_dir = _build.BUILD_DIR / "codec_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    final = (_build.CSRC / "codec.cu").read_text()
    sources = {"final": final}
    for name, edits in VARIANTS.items():
        sources[name] = variant_source(final, edits)
    if args.baseline:
        sources["baseline"] = args.baseline.read_text()
    procs = {name: start_build(name, text, out_dir) for name, text in sources.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        usage = [u for u in ptxas_usage(log) if "compress" in u or "sign" in u or "absmax" in u]
        print(f"{name}: " + "; ".join(usage), flush=True)
        tiled = "partial_pairs" not in sources[name]
        two_pass_k3 = "absmax_partials_kernel" in sources[name]
        libs[name] = (bind(out_dir / f"{name}.so", tiled, two_pass_k3), tiled,
                      "kSignThreads" in sources[name], two_pass_k3)

    g = torch.Generator(device="cuda").manual_seed(0)
    for m in (100003, SIZES["5 MiB (path)"]):
        x = torch.randn(N * m, device="cuda", generator=g)
        pmn, pmx, pp = cd.compress_chunked_plain(x, N)
        pscale, psp = cd.sign_compress_chunked_plain(x, N)
        pamax = cd.absmax_chunked_plain(x[:m], 1)
        for name, lib_args in libs.items():
            fns, out = launchers(*lib_args, x, N)
            if any(fn() for fn in fns.values()):
                raise SystemExit(f"{name}: launch failed")
            torch.cuda.synchronize()
            mn, mx, p = out["k1"]
            scale, sp = out["k4"]
            ok = (torch.equal(mn, pmn) and torch.equal(mx, pmx) and torch.equal(p, pp)
                  and torch.equal(sp, psp) and torch.equal(out["k3"], pamax)
                  and bool(((scale - pscale).abs() <= 1e-6 * pscale.abs()).all()))
            print(f"{name}: against plain (2 x {m} f32) {'equal' if ok else 'DIFFERS'}",
                  flush=True)
            if not ok:
                raise SystemExit(f"{name} disagrees with the plain versions")

    order = list(libs) + list(libs)[::-1]
    for label, m in SIZES.items():
        x = torch.randn(N * m, device="cuda", generator=g)
        hot = {name: {"k1": [], "k3": [], "k4": []} for name in libs}
        cold = {name: {"k1": [], "k3": [], "k4": []} for name in libs}
        for name in order:
            fns, _ = launchers(*libs[name], x, N)
            for k, fn in fns.items():
                hot[name][k].append(cuda_ms(fn, 20))
                cold[name][k].append(cuda_ms_cold(fn))
        x1 = x[:m].view(1, m)
        library = cuda_ms(lambda: torch.linalg.vector_norm(x1, float("inf"), dim=1), 20)
        fns, _ = launchers(*libs["final"], x, N)
        print(f"{label} (1 x {m} f32) k3 final: device duration of the kernel (profiler) "
              f"{device_us(fns['k3']):.3f} us; an empty kernel (torch.cuda._sleep(0)) "
              f"{cuda_ms(lambda: torch.cuda._sleep(0), 20) * 1e3:.3f} us from launch to launch, "
              f"{device_us(lambda: torch.cuda._sleep(0)):.3f} us on the device", flush=True)
        nbytes = cd.sign_payload_bytes(m)
        bounds = {"k1": N * m * 5 / PEAK_BYTES * 1e3, "k3": m * 4 / PEAK_BYTES * 1e3,
                  "k4": N * (m * 4 + nbytes + 4) / PEAK_BYTES * 1e3}
        print(f"{label} (1 x {m} f32) k3's library call vector_norm(inf) hot {library:.5f} ms",
              flush=True)
        for k in ("k1", "k3", "k4"):
            print(f"{label} ({1 if k == 'k3' else N} x {m} f32) {k} ms, each run twice in "
                  f"the order {order}, "
                  f"bound {bounds[k]:.5f}: " + "; ".join(
                      f"{name} hot {statistics.fmean(hot[name][k]):.5f} {hot[name][k]} cold "
                      f"{statistics.fmean(cold[name][k]):.5f} {cold[name][k]}"
                      for name in libs), flush=True)


if __name__ == "__main__":
    main()
