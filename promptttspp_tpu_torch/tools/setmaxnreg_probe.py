"""Does ptxas compile a region after ``setmaxnreg.inc`` with the raised
register count? On a machine with nvcc, from the repository root:

    python3 -m promptttspp_tpu_torch.tools.setmaxnreg_probe

writes a minimal kernel of 512 threads (128 registers a thread at launch):
warpgroup 0 raises its count to 200 with ``setmaxnreg.inc`` and then runs
one ``wgmma`` m64n256k16, whose 128 float32 accumulators and 4 A registers
need more than 128; the other warpgroups lower theirs to 96. It compiles
the kernel for sm_90a under four launch attributes (``__launch_bounds__``
with and without a minimum of blocks, ``__maxnreg__``, ``-maxrregcount``)
and prints what ptxas says of each. K2-bf16's configurations
(``csrc/amp_layer_wgmma.cu``) follow from the answer.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

from promptttspp_tpu_torch.ops.kernels import _build

ACC = 128  # m64n256 float32 accumulators a thread
ATTRS = {
    "__launch_bounds__(512, 1)": ("__launch_bounds__(512, 1)", []),
    "__launch_bounds__(512)": ("__launch_bounds__(512)", []),
    "__maxnreg__(128)": ("__maxnreg__(128)", []),
    "-maxrregcount=128": ("", ["-maxrregcount=128"]),
}


def source(attr: str) -> str:
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(ACC))
    regs = ", ".join(f"%{i}" for i in range(ACC))
    return f"""#include <cstdint>
__global__ void {attr} probe(float* out, uint64_t desc) {{
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  if (wg == 0) {{
    asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\\n");
    float d[{ACC}];
    for (int i = 0; i < {ACC}; ++i) d[i] = 0.f;
    uint32_t a[4] = {{threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u,
                     threadIdx.x * 7u}};
    asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{ACC + 5}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {{{regs}}}, "
        "{{%{ACC}, %{ACC + 1}, %{ACC + 2}, %{ACC + 3}}}, %{ACC + 4}, "
        "p, 1, 1, 0;\\n}}\\n"
        : {outs}
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
    asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < {ACC}; ++i) out[threadIdx.x * {ACC} + i] = d[i];
  }} else {{
    asm volatile("setmaxnreg.dec.sync.aligned.u32 96;\\n");
    out[threadIdx.x] = 1.f;
  }}
}}
"""


def main() -> int:
    nvcc = _build.nvcc_path()
    print(subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True).stdout.strip().splitlines()[-1])
    with tempfile.TemporaryDirectory() as tmp:
        for name, (attr, flags) in ATTRS.items():
            cu = Path(tmp) / "probe.cu"
            cu.write_text(source(attr))
            proc = subprocess.run(
                [nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-cubin", "-Xptxas", "-v", *flags, "-o",
                 str(Path(tmp) / "probe.cubin"), str(cu)],
                capture_output=True, text=True)
            said = [line.strip() for line in
                    (proc.stdout + proc.stderr).splitlines()
                    if "fatal" in line or "registers" in line
                    or "C75" in line]
            print(f"{name}: nvcc exit {proc.returncode}; " + " | ".join(said))
    return 0


if __name__ == "__main__":
    sys.exit(main())
