"""The xLSTM scan kernels' time split by clock stamps, from stamped copies
of src/repro_torch/kernels/csrc/xlstm_scan.cu and xlstm_scan_bwd.cu
(`ncu` does not run on the card):

  python3 xlstm_stamps.py [--parent PATH]

- the sLSTM step: thread 0 of each block of the first cluster stamps 64
  steps at the path shape of chip_smoke.py: the wait for h, the matvec,
  the butterfly, the block barrier, the cell update, the named barrier
  and the sends; and the landing, from the last block's sends to each
  block's wait ending (%globaltimer). With --parent PATH (a checkout of
  the parent commit, e.g. from `git archive`), the parent's kernel too;
- mlstm_scan_state_kernel's chunk: lane 0 of each warp of its first
  block stamps 64 chunks at the path shape;
- the sLSTM backward's step (slstm_scan_bwd_kernel): thread 0 of each
  block of the first cluster stamps 64 steps at the train shape (8 x
  2048), its parts in order: the coefficients, the wait for the partial
  sums, their sum and the chain (with the next trail loads), the block
  barrier, the matvec, the butterfly and the sends; and the landing. With
  --parent PATH, the parent's kernel too (the same design).

Stamps cost time of their own: a stamped step or chunk is longer than an
unstamped one (chip_smoke.py times those). The copies are written under
_archive/stamps/<tree>/ beside the tree's local headers (git ignores
_archive/) and built with `_build.build`.
Needs the card.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import xlstm_scan as xls  # noqa: E402

OUT = ROOT / "_archive" / "stamps"
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "xlstm_scan.cu"
BWD_SRC = SRC.with_name("xlstm_scan_bwd.cu")
STAMP_T0, STAMP_N, STAMPS = 20000, 64, 12
STAMP_NAMES = ("wait", "matvec", "butterfly", "block barrier",
               "cell update", "named barrier", "sends")


def edit(text: str, pairs) -> str:
    """`text` with each (old, new) replaced; each old must occur once."""
    for old, new in pairs:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    return text


def stamped(src: str) -> str:
    """The sLSTM with clock stamps: thread 0 of each block of cluster
    (0, 0) records clock64 at the step's part boundaries, and
    %globaltimer where its wait ends and its sends are out, for steps
    STAMP_T0 .. STAMP_T0 + STAMP_N; `slstm_stamps` copies them out."""
    rec = "if (stp) sp[{}] = clk();"
    pairs = [
        ("__device__ __forceinline__ float log_sigmoid(float x) {",
         f"constexpr int kStampT0 = {STAMP_T0}, kStampN = {STAMP_N}, "
         f"kStamps = {STAMPS};\n"
         "__device__ unsigned long long g_stamp[kStampN][32][kStamps];\n"
         "__device__ __forceinline__ unsigned long long clk() {\n"
         "  unsigned long long c;\n"
         "  asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(c) :: "
         "\"memory\");\n  return c;\n}\n"
         "__device__ __forceinline__ unsigned long long gtime() {\n"
         "  unsigned long long c;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(c) :: "
         "\"memory\");\n  return c;\n}\n\n"
         "__device__ __forceinline__ float log_sigmoid(float x) {"),
        ("      xr[j] = valid && t + kSAhead < a.S ? xp[(t + kSAhead) * "
         "xstep] : 0.f;\n",
         "      xr[j] = valid && t + kSAhead < a.S ? xp[(t + kSAhead) * "
         "xstep] : 0.f;\n"
         "      const int ws = t - kStampT0;\n"
         "      const bool stp = blockIdx.y == 0 && blockIdx.z == 0 && "
         "threadIdx.x == 0 && ws >= 0 && ws < kStampN;\n"
         "      unsigned long long sp[kStamps];\n"
         "      if (stp) { sp[0] = clk(); sp[8] = gtime(); }\n"),
        ("        if (threadIdx.x == 0) mbar_expect(bar, kBytes);\n      }\n",
         "        if (threadIdx.x == 0) mbar_expect(bar, kBytes);\n      }\n"
         "      if (stp) { sp[1] = clk(); sp[9] = gtime(); }\n"),
        ("                fmaf(wt[gg][jj], hv[bb], v[gg * kSBatch + bb]);\n"
         "      }\n",
         "                fmaf(wt[gg][jj], hv[bb], v[gg * kSBatch + bb]);\n"
         "      }\n      asm volatile(\"\" :: \"f\"(v[0]), \"f\"(v[kV - 1]));\n"
         f"      {rec.format(2)}\n"),
        ('extern "C" const char* xlstm_scan_error_string(int code) {',
         'extern "C" int slstm_stamps(unsigned long long* out) {\n'
         "  return static_cast<int>(\n"
         "      cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp)));\n}\n\n"
         'extern "C" const char* xlstm_scan_error_string(int code) {'),
        ("      __syncthreads();\n      if (threadIdx.x < kCellThreads) {",
         f"      {rec.format(3)}\n      __syncthreads();\n"
         f"      {rec.format(4)}\n"
         "      if (threadIdx.x < kCellThreads) {"),
        ("        named_barrier(1, kCellThreads);\n",
         f"        {rec.format(5)}\n        named_barrier(1, kCellThreads);"
         f"\n        {rec.format(6)}\n"),
        ("                      v.w, map_rank(bar, to));\n          }\n"
         "        }\n",
         "                      v.w, map_rank(bar, to));\n          }\n"
         "        }\n        if (stp) { sp[7] = clk(); sp[10] = gtime(); "
         "sp[11] = 0;\n#pragma unroll\n        for (int q = 0; q < kStamps; "
         "++q) g_stamp[ws][rank][q] = sp[q]; }\n")]
    if "mlstm_scan_state_kernel" in src:
        pairs += state_stamps()
    return edit(src, pairs)


MSTAMP_J0, MSTAMP_NAMES = 100, (
    "the chunk state's stores", "the next loads out, wait, block barrier",
    "V scaled, block barrier", "the products", "n (three warps)",
    "the next chunk's weights (warp 0)")


def state_stamps() -> list:
    """Clock stamps in mlstm_scan_state_kernel: lane 0 of each warp of
    block (0, 0), chunks MSTAMP_J0 .. + 64; `mstate_stamps` copies them."""
    rec = "if (stq) sq[{}] = clk();"
    return [
        ("__device__ __forceinline__ float log_sigmoid(float x) {",
         "__device__ unsigned long long g_mstamp[64][8][8];\n"
         "__device__ __forceinline__ float log_sigmoid(float x) {"),
        ("  for (int j = 0;; ++j) {\n    // the state before chunk j\n",
         "  for (int j = 0;; ++j) {\n"
         f"    const int wsj = j - {MSTAMP_J0};\n"
         "    const bool stq = blockIdx.x == 0 && blockIdx.y == 0 && lane == 0"
         " && wsj >= 0 && wsj < 64;\n"
         "    unsigned long long sq[8];\n"
         f"    {rec.format(0)}\n"),
        ("    if (j + 1 >= nch) break;\n",
         f"    {rec.format(1)}\n    if (j + 1 >= nch) break;\n"),
        ("    __syncthreads();            // chunk j's K, V and weights\n",
         "    __syncthreads();            // chunk j's K, V and weights\n"
         f"    {rec.format(2)}\n"),
        ("    __syncthreads();\n#pragma unroll\n    for (int r = 0; r < kMTileT;"
         " ++r)\n#pragma unroll\n      for (int q = 0; q < kMTileT; ++q) "
         "acc[r][q] *= e;",
         f"    __syncthreads();\n    {rec.format(3)}\n"
         "#pragma unroll\n    for (int r = 0; r < kMTileT;"
         " ++r)\n#pragma unroll\n      for (int q = 0; q < kMTileT; ++q) "
         "acc[r][q] *= e;"),
        ("    if (nrow) {\n      n_k *= e;",
         "    asm volatile(\"\" :: \"f\"(acc[0][0]), "
         "\"f\"(acc[kMTileT - 1][kMTileT - 1]));\n"
         f"    {rec.format(4)}\n    if (nrow) {{\n      n_k *= e;"),
        ("    if (warp == 0 && j + 2 < nch) {          // chunk j + 1's weights",
         "    asm volatile(\"\" :: \"f\"(n_k));\n"
         f"    {rec.format(5)}\n"
         "    if (warp == 0 && j + 2 < nch) {          // chunk j + 1's weights"),
        ("      m_gate_load(a, b, h, (j + 2) * kMChunk, lane, iv, fv);\n    }\n",
         "      m_gate_load(a, b, h, (j + 2) * kMChunk, lane, iv, fv);\n    }\n"
         f"    if (stq) {{ {rec.format(6)[9:]} sq[7] = 0;\n"
         "#pragma unroll\n"
         "      for (int q = 0; q < 8; ++q) g_mstamp[wsj][warp][q] = sq[q]; }\n"),
        ('extern "C" const char* xlstm_scan_error_string(int code) {',
         'extern "C" int mstate_stamps(unsigned long long* out) {\n'
         "  return static_cast<int>(\n"
         "      cudaMemcpyFromSymbol(out, g_mstamp, sizeof(g_mstamp)));\n}\n\n"
         'extern "C" const char* xlstm_scan_error_string(int code) {')]


# the sLSTM backward: walk steps BSTAMP_U0 .. + STAMP_N at the train shape
BSTAMP_U0 = 1000
BSTAMP_CLOCK = """__device__ unsigned long long g_bstamp[{n}][32][{k}];
__device__ __forceinline__ unsigned long long clk() {{
  unsigned long long c;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c) :: "memory");
  return c;
}}
__device__ __forceinline__ unsigned long long gtime() {{
  unsigned long long c;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(c) :: "memory");
  return c;
}}

__device__ __forceinline__ float log_sigmoid(float x) {{"""
# the parts of a step, between stamps 0 .. 7; stamp 8 is %globaltimer
# where the sends are out, 9 where the wait ends; a send lands at the wait
# of the next step
BWD_NAMES = ("coefficients", "wait", "sum and chain", "block barrier",
             "matvec", "butterfly", "sends")


def bwd_stamped(src: str) -> str:
    """The sLSTM backward with clock stamps: thread 0 of each block of
    cluster (0, 0) records clock64 at the step's part boundaries for walk
    steps BSTAMP_U0 .. + STAMP_N; `slstm_bwd_stamps` copies them out."""
    rec = "if (stp) sp[{}] = clk();"
    head = (f"      const int ws = u - {BSTAMP_U0};\n"
            "      const bool stp = blockIdx.y == 0 && blockIdx.z == 0 && "
            "threadIdx.x == 0 && ws >= 0 && ws < " + str(STAMP_N) + ";\n"
            "      unsigned long long sp[12];\n"
            f"      {rec.format(0)}\n")
    flush = ("if (stp) { sp[10] = 0; sp[11] = 0;\n#pragma unroll\n"
             "        for (int q = 0; q < 12; ++q) g_bstamp[ws][rank][q] = "
             "sp[q]; }\n")
    pairs = [("__device__ __forceinline__ float log_sigmoid(float x) {",
              BSTAMP_CLOCK.format(n=STAMP_N, k=12)),
             ('extern "C" const char* xlstm_scan_bwd_error_string(int code) {',
              'extern "C" int slstm_bwd_stamps(unsigned long long* out) {\n'
              "  return static_cast<int>(\n"
              "      cudaMemcpyFromSymbol(out, g_bstamp, sizeof(g_bstamp)));"
              "\n}\n\n"
              'extern "C" const char* xlstm_scan_bwd_error_string(int code) {'),
             ("      if (t < 0) break;\n      const int buf = u & 1;\n",
              "      if (t < 0) break;\n      const int buf = u & 1;\n"
              + head),
             ("        const float dy = dyr[j];\n",
              "        const float dy = dyr[j];\n"
              "        asm volatile(\"\" :: \"f\"(k.a1), \"f\"(k.a2), "
              "\"f\"(k.g1), \"f\"(k.g2), \"f\"(k.bz), \"f\"(k.sgf));\n"
              f"        {rec.format(1)}\n"),
             ("          if (threadIdx.x == 0) mbar_expect(bar, kBytes);\n",
              "          if (threadIdx.x == 0) mbar_expect(bar, kBytes);\n"
              "          if (stp) { sp[2] = clk(); sp[9] = gtime(); }\n"),
             ("      __syncthreads();\n      if (t == 0) break;\n",
              f"      {rec.format(3)}\n      __syncthreads();\n"
              f"      {rec.format(4)}\n      if (t == 0) break;\n"),
             ("      int cnt = 16;",
              "      asm volatile(\"\" :: \"f\"(s[0]), \"f\"(s[15]));\n"
              f"      {rec.format(5)}\n      int cnt = 16;"),
             ("      // to the block that owns w, into buffer (u + 1) & 1\n",
              "      asm volatile(\"\" :: \"f\"(s[0]), \"f\"(s[1]));\n"
              f"      {rec.format(6)}\n"
              "      // to the block that owns w, into buffer (u + 1) & 1\n"),
             ("                s[1], map_rank(nbar, dst));\n",
              "                s[1], map_rank(nbar, dst));\n"
              "      if (stp) { sp[7] = clk(); sp[8] = gtime(); }\n      "
              + flush)]
    return edit(src, pairs)


def bwd_split(label: str, path: Path, trails, w_r, dy) -> None:
    """Run a stamped backward library at the train shape and print each
    part's median (cycles and ns) by block, and the landing."""
    lib = ctypes.CDLL(str(path))
    lib.slstm_scan_bwd_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.slstm_bwd_stamps.argtypes = [ctypes.c_void_p]
    p = trails[0]
    b, s, _, nh, hd = p.shape
    dpre = torch.empty_like(p)
    args = xls._SlstmBwdArgs(w_r.data_ptr(), *(t.data_ptr() for t in trails),
                             dy.data_ptr(), dpre.data_ptr(), b, s, nh, hd)
    for _ in range(2):
        assert lib.slstm_scan_bwd_f32(
            ctypes.byref(args), torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (STAMP_N * 32 * 12))()
    assert lib.slstm_bwd_stamps(ctypes.addressof(buf)) == 0
    st = torch.tensor(list(buf), dtype=torch.float64).reshape(STAMP_N, 32, 12)
    ranks = int((st[0, :, 0] > 0).sum())
    st = st[:, :ranks]
    ns = ((st[-1, :, 8] - st[0, :, 8]) / (st[-1, :, 0] - st[0, :, 0])).mean()
    step = (st[1:, :, 0] - st[:-1, :, 0]).median().item()
    print(f"[stamp] slstm_scan_bwd_kernel, {label}: {ranks} blocks a cluster;"
          f" {ns.item():.4f} ns a clock; a step {step:.0f} clocks = "
          f"{step * ns.item():.1f} ns (median over walk steps {BSTAMP_U0}.. "
          f"and blocks)")
    for i, name in enumerate(BWD_NAMES):
        part = st[:, :, i + 1] - st[:, :, i]
        print(f"[stamp]   {name}: {part.median().item():.0f} clocks "
              f"({part.median().item() * ns.item():.1f} ns); by block "
              + " ".join(f"{part[:, r].median().item():.0f}"
                         for r in range(ranks)))
    sent = st[:STAMP_N - 1, :, 8].amax(1, keepdim=True)
    landing = st[1:, :, 9] - sent
    print(f"[stamp]   landing (the last block's sends out to this block's "
          f"wait done): {landing.median().item():.0f} ns; by block "
          + " ".join(f"{landing[:, r].median().item():.0f}"
                     for r in range(ranks)))
    del dpre


def state_split(path: Path, gen) -> None:
    """Run the stamped states kernel at the path shape and print each
    part's median (cycles) by warp of block (0, 0)."""
    lib = xls.load(path)
    lib.mstate_stamps.argtypes = [ctypes.c_void_p]
    args = cs.xlstm_inputs("mlstm_scan", cs.XLSTM_CASES["path"], gen)
    cargs, y, kept = xls._mlstm_args(*args, lib.xlstm_scan_layout(0))
    for _ in range(2):
        assert lib.mlstm_scan_state_f32(
            ctypes.byref(cargs), torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (64 * 8 * 8))()
    assert lib.mstate_stamps(ctypes.addressof(buf)) == 0
    st = torch.tensor(list(buf), dtype=torch.float64).reshape(64, 8, 8)
    chunk = (st[1:, :, 0] - st[:-1, :, 0]).median().item()
    print(f"[stamp] mlstm_scan_state_kernel, block (0, 0), chunks "
          f"{MSTAMP_J0}..: a chunk {chunk:.0f} clocks (median over chunks "
          f"and warps)")
    for i, name in enumerate(MSTAMP_NAMES):
        part = st[:, :, i + 1] - st[:, :, i]
        print(f"[stamp]   {name}: by warp " + " ".join(
            f"{part[:, w].median().item():.0f}" for w in range(8)))
    del args, y, kept
    torch.cuda.empty_cache()


def slstm_call(lib):
    """A plain ctypes call of `slstm_scan_f32` in `lib`."""
    def fn(pre, w, bias):
        b, s, _, nh, hd = pre.shape
        y = torch.empty((b, s, nh, hd), device="cuda")
        args = xls._SlstmArgs(pre.data_ptr(), w.data_ptr(), bias.data_ptr(),
                              y.data_ptr(), None, None, None, None, b, s,
                              nh, hd)
        err = lib.slstm_scan_f32(ctypes.byref(args),
                                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, lib.xlstm_scan_error_string(err)
        return y
    return fn


def stamp_split(label: str, path: Path, gen) -> None:
    """Run a stamped library at the path shape and print each part's
    median (cycles and ns) by block, and the landing."""
    lib = ctypes.CDLL(str(path))
    lib.slstm_scan_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.slstm_stamps.argtypes = [ctypes.c_void_p]
    lib.xlstm_scan_error_string.restype = ctypes.c_char_p
    case = cs.XLSTM_CASES["path"]
    args = cs.xlstm_inputs("slstm_scan", case, gen)
    fn = slstm_call(lib)
    for _ in range(2):
        fn(*args)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (STAMP_N * 32 * STAMPS))()
    assert lib.slstm_stamps(ctypes.addressof(buf)) == 0
    st = torch.tensor(list(buf), dtype=torch.float64).reshape(STAMP_N, 32,
                                                               STAMPS)
    ranks = int((st[0, :, 0] > 0).sum())
    st = st[:, :ranks]
    ns = ((st[-1, :, 8] - st[0, :, 8]) / (st[-1, :, 0] - st[0, :, 0])).mean()
    step = (st[1:, :, 0] - st[:-1, :, 0]).median().item()
    print(f"[stamp] {label}: {ranks} blocks a cluster; {ns.item():.4f} ns a "
          f"clock; a step {step:.0f} clocks = {step * ns.item():.1f} ns "
          f"(median over steps {STAMP_T0}.. and blocks)")
    for i, name in enumerate(STAMP_NAMES):
        part = st[:, :, i + 1] - st[:, :, i]
        print(f"[stamp]   {name}: {part.median().item():.0f} clocks "
              f"({part.median().item() * ns.item():.1f} ns); by block "
              + " ".join(f"{part[:, r].median().item():.0f}"
                         for r in range(ranks)))
    landing = st[1:, :, 9] - st[:-1, :, 10].amax(1, keepdim=True)
    print(f"[stamp]   landing (the last block's sends out to this block's "
          f"wait done): {landing.median().item():.0f} ns; by block "
          + " ".join(f"{landing[:, r].median().item():.0f}"
                     for r in range(ranks)))
    del args
    torch.cuda.empty_cache()


def copy_headers(root: Path, out: Path) -> Path:
    """`out`, made, with a copy of each local header of `root`'s csrc/
    (the stamped copies written there include them); returns `out`."""
    out.mkdir(parents=True, exist_ok=True)
    for header in (root / SRC.relative_to(ROOT)).parent.glob("*.cuh"):
        (out / header.name).write_bytes(header.read_bytes())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("xlstm_stamps.py needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    OUT.mkdir(parents=True, exist_ok=True)
    trees = {"this tree": ROOT}
    if opts.parent is not None:
        trees["parent"] = opts.parent
    dirs = {label: copy_headers(root, OUT / label.replace(" ", "_"))
            for label, root in trees.items()}
    paths = {}
    for label, root in trees.items():
        paths[label] = dirs[label] / SRC.name
        paths[label].write_text(stamped((root / SRC.relative_to(ROOT))
                                        .read_text()))
    t0 = time.time()
    with ThreadPoolExecutor(len(paths)) as pool:
        libs = dict(zip(paths, pool.map(
            lambda p: _build.build("xlstm_scan", src=p), paths.values())))
    print(f"[build] {len(libs)} stamped copies in {time.time() - t0:.1f} s")
    gen = torch.Generator("cuda").manual_seed(0)
    for label, lib in libs.items():
        stamp_split(label, lib, gen)
    state_split(libs["this tree"], gen)
    bpaths = {}
    for label, root in trees.items():
        bpaths[label] = dirs[label] / BWD_SRC.name
        bpaths[label].write_text(bwd_stamped(
            (root / BWD_SRC.relative_to(ROOT)).read_text()))
    with ThreadPoolExecutor(len(bpaths)) as pool:
        blibs = dict(zip(bpaths, pool.map(
            lambda p: _build.build("xlstm_scan_bwd", src=p),
            bpaths.values())))
    case = cs.XLSTM_BWD_CASES["train"]
    args = cs.xlstm_inputs("slstm_scan", case, gen)
    dy = torch.randn(case, generator=gen, device="cuda")
    with torch.no_grad():
        trails = xls._slstm_fwd(*args, trails=True)[1:]
    for label, lib in blibs.items():
        bwd_split(label, lib, trails, args[1], dy)
    return 0


if __name__ == "__main__":
    sys.exit(main())
