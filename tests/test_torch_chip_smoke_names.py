"""chip_smoke.py's names for the port's GPU kernels, on the CPU.

The smoke script files every compiled and profiled GPU function under a row
of the port's kernel table: from nvcc's -Xptxas -v log (mangled names:
registers, spills, ptxas's wgmma-serialisation warnings) and from the
profiler (demangled names: device time by class). The Hopper forward
mainloop `attn_fwd_kernel` serves five rows, told apart only by its epilogue
policy's type, so a new policy that the names miss would be filed under
another row. The names here are ptxas's and the profiler's own spelling of
this repository's kernels, on synthetic log lines; nothing needs a card.
"""

import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke

ROOT = Path(__file__).resolve().parents[1]
FWD = "_ZN45_GLOBAL__N__ef34e349_12_flash_fwd_cu_532615524fwdh15attn_fwd_kernel"
MANGLED = {  # row → the entry function as ptxas names it
    "flash_fwd": FWD + "INS_8InferOutILi128EEEEEvNS0_4MapsET_f",
    "flash_d72": FWD + "INS_8InferOutILi72EEEEEvNS0_4MapsET_f",
    "flash_fwd_lse": FWD + "INS_6LseOutEEEvNS0_4MapsET_f",
    "ring_step": "_ZN45_GLOBAL__N__9d0a7f4e_12_ring_step_cu_c53667124fwdh15attn_fwd_kernel"
                 "INS_9RingCarryEEEvNS0_4MapsET_f",
    "flash_causal": FWD + "INS_9CausalOutEEEvNS0_4MapsET_f",
    "flash_bwd_dq": "_ZN47_GLOBAL__N__73e51205_14_flash_train_cu_c35d950c19flash_bwd_dq_kernel"
                    "E14CUtensorMap_stS0_S0_S0_PKfS2_PfPKiiiif",
    "flash_bwd_dkv": "_ZN47_GLOBAL__N__73e51205_14_flash_train_cu_c35d950c20flash_bwd_dkv_kernel"
                     "E14CUtensorMap_stS0_S0_S0_PKfS2_PfS3_PKiiiif",
    "qk_prep": "_ZN43_GLOBAL__N__9e9c376c_10_qk_prep_cu_a100dbdc14qk_prep_kernel"
               "EPK13__nv_bfloat16S2_PKfS4_PS0_Pfiiiiif",
    "fused_adaln": "_ZN40_GLOBAL__N__4f4767a5_8_adaln_cu_0e84efa312adaln_kernel"
                   "EPKfPKvS1_S1_S1_S1_S1_PfPviiiif",
}
_NS = "(anonymous namespace)::"
DEMANGLED = {  # row → the kernel as the profiler names it
    "flash_fwd": f"void {_NS}fwdh::attn_fwd_kernel<{_NS}InferOut<128> >({_NS}fwdh::Maps, "
                 f"{_NS}InferOut<128>, float)",
    "flash_d72": f"void {_NS}fwdh::attn_fwd_kernel<{_NS}InferOut<72> >({_NS}fwdh::Maps, "
                 f"{_NS}InferOut<72>, float)",
    "flash_fwd_lse": f"void {_NS}fwdh::attn_fwd_kernel<{_NS}LseOut>({_NS}fwdh::Maps, "
                     f"{_NS}LseOut, float)",
    "ring_step": f"void {_NS}fwdh::attn_fwd_kernel<{_NS}RingCarry>({_NS}fwdh::Maps, "
                 f"{_NS}RingCarry, float)",
    "flash_causal": f"void {_NS}fwdh::attn_fwd_kernel<{_NS}CausalOut>({_NS}fwdh::Maps, "
                    f"{_NS}CausalOut, float)",
    "flash_bwd_dq": f"{_NS}flash_bwd_dq_kernel(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
                    "CUtensorMap_st, float const*, float const*, float*, int const*, int, int, "
                    "int, float)",
    "flash_bwd_dkv": f"{_NS}flash_bwd_dkv_kernel(CUtensorMap_st, CUtensorMap_st, "
                     "CUtensorMap_st, CUtensorMap_st, float const*, float const*, float*, float*, "
                     "int const*, int, int, int, float)",
    "qk_prep": f"{_NS}qk_prep_kernel(__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, "
               "float const*, __nv_bfloat16*, float*, int, int, int, int, int, float)",
    "fused_adaln": f"{_NS}adaln_kernel(float const*, __nv_bfloat16 const*, void const*, "
                   "void const*, void const*, void const*, float*, void*, int, int, int, int, "
                   "int, float)",
}


def _ptxas_block(name: str, registers: int, spill: int) -> str:
    """The lines ptxas -v prints for one entry function."""
    return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    0 bytes stack frame, {spill} bytes spill stores, {2 * spill} bytes spill loads\n"
            f"ptxas info    : Used {registers} registers, used 16 barriers\n"
            f"ptxas info    : Compile time = 301.500 ms\n")


def test_tables_cover_every_kernel_row():
    assert set(MANGLED) == set(DEMANGLED) == set(chip_smoke.KERNEL_ROWS)


@pytest.mark.parametrize("row", sorted(MANGLED))
def test_kernel_row_from_mangled_name(row):
    assert chip_smoke.kernel_row(MANGLED[row]) == row


@pytest.mark.parametrize("row", sorted(DEMANGLED))
def test_kernel_class_from_demangled_name(row):
    assert chip_smoke.kernel_row(DEMANGLED[row]) == row
    assert chip_smoke._kernel_class(DEMANGLED[row]) == row


@pytest.mark.parametrize("name,cls", [
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float> >", "elementwise"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x256x64_warpgroupsize2x1x1", "gemm"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float> >", "reduce"),
    (FWD + "INS_8InferOutILi96EEEEEvNS0_4MapsET_f", "other"),  # no such row
])
def test_kernel_class_of_other_functions(name, cls):
    assert chip_smoke._kernel_class(name) == cls


@pytest.mark.parametrize("row", sorted(MANGLED))
def test_ptxas_by_kernel_reports_each_row(row):
    """One row's registers and spills among the others' (its block in the
    middle of the log, the others with their own numbers)."""
    rows = sorted(MANGLED)
    log = "ptxas info    : 0 bytes gmem\n" + "".join(
        _ptxas_block(MANGLED[r], 100 + i, 8 * i) for i, r in enumerate(rows))
    i = rows.index(row)
    got = chip_smoke.ptxas_by_kernel(log)
    assert set(got) == set(rows)
    assert got[row] == {"registers": 100 + i, "spill_stores": 8 * i, "spill_loads": 16 * i}


@pytest.mark.parametrize("line,hit", [
    ("ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async instructions are "
     f"serialized due to the presence of Extern calls in the function '{MANGLED['flash_fwd']}'",
     True),
    (f"ptxas warning : (C7515) Potential Performance Loss: wgmma.mma_async instructions are "
     f"serialized due to insufficient register resources in the function "
     f"'{MANGLED['flash_d72']}'", True),
    ("ptxas info    : Used 168 registers, used 16 barriers", False),
    (f"ptxas info    : Compiling entry function '{MANGLED['ring_step']}' for 'sm_90a'", False),
])
def test_serialised_wgmma(line, hit):
    log = _ptxas_block(MANGLED["flash_fwd_lse"], 168, 0) + line + "\n"
    assert chip_smoke.serialised_wgmma(log) == ([line.strip()] if hit else [])


def test_import_starts_nothing():
    """Importing chip_smoke touches no device and starts no thread or
    process: the tests import it on machines without a card."""
    code = ("import multiprocessing, threading, torch, chip_smoke; "
            "print(threading.active_count(), len(multiprocessing.active_children()), "
            "torch.cuda.is_initialized())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, timeout=300).stdout.split()
    assert out == ["1", "0", "False"]
