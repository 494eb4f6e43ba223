"""chip_smoke.py's names for the port's GPU kernels, on the CPU.

The smoke script files every compiled and profiled GPU function under a row
of the port's kernel table: from nvcc's -Xptxas -v log (mangled names:
registers, spills, ptxas's wgmma-serialisation warnings) and from the
profiler (demangled names: device time by class). The Hopper forward
mainloop `attn_fwd_kernel` serves five rows, told apart only by its epilogue
policy's type, so a new policy that the names miss would be filed under
another row; the i2v cross-attention's pair kernel is a kernel of its own,
and so are the f32 ring step (TF32 tensor cores, its own Maps and Step) and
rows 4 and 5 on f32 operands, whose names hold the bf16 rows' as a prefix. The names here are
ptxas's and the profiler's own spelling of this repository's kernels, on
synthetic log lines; nothing needs a card.
The script's stand-in tokenizer and safetensors writer, which stand in for
packages the card's machine may lack, are checked here too.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke

ROOT = Path(__file__).resolve().parents[1]
FWD = "_ZN45_GLOBAL__N__ef34e349_12_flash_fwd_cu_532615524fwdh15attn_fwd_kernel"
GMM_NS = "_ZN42_GLOBAL__N__1b2c3d4e_6_gmm_cu_5f6a7b8c"
MANGLED = {  # row → the entry function as ptxas names it
    "flash_fwd": FWD + "INS_8InferOutILi128EEEEEvNS0_4MapsET_f",
    "flash_d72": FWD + "INS_8InferOutILi72EEEEEvNS0_4MapsET_f",
    "flash_fwd_lse": FWD + "INS_6LseOutEEEvNS0_4MapsET_f",
    "ring_step": "_ZN45_GLOBAL__N__9d0a7f4e_12_ring_step_cu_c53667124fwdh15attn_fwd_kernel"
                 "INS_9RingCarryEEEvNS0_4MapsET_f",
    "flash_causal": FWD + "INS_9CausalOutEEEvNS0_4MapsET_f",
    "flash_pair": "_ZN46_GLOBAL__N__31923074_13_flash_pair_cu_37d3788817flash_pair_kernel"
                  "ENS_8PairMapsENS_8PairArgsE",
    "flash_bwd_dq": "_ZN47_GLOBAL__N__73e51205_14_flash_train_cu_c35d950c19flash_bwd_dq_kernel"
                    "E14CUtensorMap_stS0_S0_S0_PKfS2_PfPKiiiif",
    "flash_bwd_dkv": "_ZN47_GLOBAL__N__73e51205_14_flash_train_cu_c35d950c20flash_bwd_dkv_kernel"
                     "E14CUtensorMap_stS0_S0_S0_PKfS2_PfS3_PKiiiif",
    "flash_bwd_dq_f32": "_ZN51_GLOBAL__N__28127ecd_18_flash_train_f32_cu_14af81a9"
                        "23flash_bwd_dq_f32_kernelENS_4ArgsEPf",
    "flash_bwd_dkv_f32": "_ZN51_GLOBAL__N__28127ecd_18_flash_train_f32_cu_14af81a9"
                         "24flash_bwd_dkv_f32_kernelENS_4ArgsEPfS1_",
    "qk_prep": "_ZN43_GLOBAL__N__9e9c376c_10_qk_prep_cu_a100dbdc14qk_prep_kernel"
               "EPK13__nv_bfloat16S2_PKfS4_PS0_Pfiiiiif",
    "fused_adaln": "_ZN40_GLOBAL__N__4f4767a5_8_adaln_cu_0e84efa312adaln_kernel"
                   "EPKfPKvS1_S1_S1_S1_S1_PfPviiiif",
    "ring_step_f32": "_ZN49_GLOBAL__N__ba5cd9de_16_ring_step_f32_cu_7d4311e220ring_step_f32_kernel"
                     "ENS_4MapsENS_4StepE",
    "gmm": GMM_NS + "16gmm_wgmma_kernelILb0EEEvNS_4MapsENS_4ArgsE",
    "tgmm": GMM_NS + "17tgmm_wgmma_kernelENS_4MapsENS_4ArgsE",
}
ROW9_MANGLED = (  # every entry function of rows 9 and 9b, with its row
    (GMM_NS + "16gmm_wgmma_kernelILb1EEEvNS_4MapsENS_4ArgsE", "gmm"),
    (GMM_NS + "17gmm_splitk_kernelILb0EEEvNS_4MapsENS_4ArgsEiii", "gmm"),
    (GMM_NS + "15gmm_tf32_kernelILb1EEEvNS_4MapsENS_2tf4ArgsE", "gmm"),
    (GMM_NS + "17tgmm_wgmma_kernelENS_4MapsENS_4ArgsE", "tgmm"),
    (GMM_NS + "16tgmm_tf32_kernelENS_4MapsENS_2tf4ArgsE", "tgmm"),
)
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
    "flash_pair": f"{_NS}flash_pair_kernel({_NS}PairMaps, {_NS}PairArgs)",
    "flash_bwd_dq": f"{_NS}flash_bwd_dq_kernel(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
                    "CUtensorMap_st, float const*, float const*, float*, int const*, int, int, "
                    "int, float)",
    "flash_bwd_dkv": f"{_NS}flash_bwd_dkv_kernel(CUtensorMap_st, CUtensorMap_st, "
                     "CUtensorMap_st, CUtensorMap_st, float const*, float const*, float*, float*, "
                     "int const*, int, int, int, float)",
    "flash_bwd_dq_f32": f"{_NS}flash_bwd_dq_f32_kernel({_NS}Args, float*)",
    "flash_bwd_dkv_f32": f"{_NS}flash_bwd_dkv_f32_kernel({_NS}Args, float*, float*)",
    "qk_prep": f"{_NS}qk_prep_kernel(__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, "
               "float const*, __nv_bfloat16*, float*, int, int, int, int, int, float)",
    "fused_adaln": f"{_NS}adaln_kernel(float const*, __nv_bfloat16 const*, void const*, "
                   "void const*, void const*, void const*, float*, void*, int, int, int, int, "
                   "int, float)",
    "ring_step_f32": f"{_NS}ring_step_f32_kernel({_NS}Maps, {_NS}Step)",
    "gmm": f"void {_NS}gmm_splitk_kernel<true>({_NS}Maps, {_NS}Args, int, int, int)",
    "tgmm": f"{_NS}tgmm_wgmma_kernel({_NS}Maps, {_NS}Args)",
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
    (f"{_NS}gmm_meta_kernel(int const*, int, int, int*)", "other"),  # not a product
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


@pytest.mark.parametrize("name,row", ROW9_MANGLED)
def test_kernel_row_of_each_grouped_product(name, row):
    assert chip_smoke.kernel_row(name) == row


def test_ptxas_by_kernel_takes_the_most_over_a_rows_kernels():
    """Rows 9 and 9b are served by several entry functions: the report
    keeps each row's most registers and spills, whichever kernel has them."""
    log = "".join(_ptxas_block(name, 90 + 20 * i, 4 * (i % 2))
                  for i, (name, _) in enumerate(ROW9_MANGLED))
    got = chip_smoke.ptxas_by_kernel(log)
    assert got == {"gmm": {"registers": 130, "spill_stores": 4, "spill_loads": 8},
                   "tgmm": {"registers": 170, "spill_stores": 4, "spill_loads": 8}}


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


def test_stand_in_tokenizer_splits_the_qwen_specials():
    """chip_smoke's tokenizer for the engine pass (the card's machine may
    lack `tokenizers`): the chat and vision specials at their Qwen3-VL ids,
    every other byte as its value, and the chat layout the engine builds
    with it holds one <|video_pad|> per merged visual token."""
    from omnivideo_tpu_torch.models.qwen3vl.preprocess import build_chat_ids

    tok = chip_smoke.StandInTokenizer()
    ids = tok("<|im_start|>user\nhé<|video_pad|><|im_end|>")["input_ids"]
    assert ids == [151644, *b"user\n", *"hé".encode(), 151656, 151645]
    assert tok.decode(ids) == "user\nhé" and tok.eos_token_id == 151645
    assert (tok.decode(ids, skip_special_tokens=False)
            == "<|im_start|>user\nhé<|video_pad|><|im_end|>")
    assert tok.decode([151000, 65]) == "?A"
    chat = build_chat_ids(tok, "edit", "sys", grid=(3, 44, 80), timestamps=[0.5, 1.0, 1.5])
    assert int((chat == 151656).sum()) == 3 * 44 * 80 // 4
    assert int((chat == 151652).sum()) == int((chat == 151653).sum()) == 3


def test_safetensors_writer_reads_back(tmp_path):
    """chip_smoke's safetensors writer (the card's machine may lack the
    package): the `safetensors` package and the port's reader read every
    tensor back bit for bit."""
    from safetensors.torch import load_file

    from omnivideo_tpu_torch.io.safetensors import load_safetensors

    g = torch.Generator().manual_seed(0)
    src = {"w.bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
           "w.f32": torch.randn(7, generator=g), "i.i64": torch.arange(4),
           "m.bool": torch.tensor([True, False, True]), "s.f32": torch.tensor(1.5)}
    n = chip_smoke.write_safetensors(tmp_path / "w.safetensors", src)
    assert n == (tmp_path / "w.safetensors").stat().st_size
    for got in (load_file(str(tmp_path / "w.safetensors")),
                load_safetensors(tmp_path / "w.safetensors", device="cpu")):
        assert set(got) == set(src)
        for k, v in src.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("phase,entry", [("profile", "phase_profile"), ("sp", "phase_sp"),
                                         ("sp_train", "_sp_train_alone"), ("lora", "phase_lora"),
                                         ("adafactor", "phase_adafactor"),
                                         ("qwen3_sp", "phase_vlm"), ("sft", "phase_sft"),
                                         ("i2v", "_i2v_alone"), ("stream", "_stream_alone"),
                                         ("stream_train", "_stream_train_alone"),
                                         ("serve", "_serve_alone"), ("gmm", "_gmm_alone")])
def test_phase_commands(monkeypatch, phase, entry):
    """`python3 chip_smoke.py <phase>` runs that phase alone (lora and
    adafactor after the train phase, their AdamW yardstick; qwen3_sp inside
    the vlm phase, whose text stack it runs; sft after tiny_sft; i2v after the
    flash phase, with tiny_i2v, vae22 and xlm; stream after the cli and a14b
    phases, whose row and weights it reuses; stream_train alone; serve, export
    and eval_videos after e2e, whose pipeline they reuse); any other
    argument is refused with the list of names."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name in ("phase_device", "phase_profile", "phase_sp", "_sp_train_alone", "t2v_pipeline",
                 "phase_train", "phase_lora", "phase_adafactor", "phase_vlm", "write_clip",
                 "phase_tiny_sft", "phase_sft", "_i2v_alone", "_stream_alone",
                 "_stream_train_alone", "_serve_alone", "_gmm_alone"):
        monkeypatch.setattr(chip_smoke, name, lambda *a, _n=name, **k: calls.append(_n) or (
            (None, torch.zeros(1), torch.Generator()) if _n == "t2v_pipeline" else 0))
    monkeypatch.setattr(torch, "randn", lambda *a, **k: torch.zeros(1))
    assert chip_smoke.main([phase]) == 0
    assert entry in calls
    with pytest.raises(SystemExit, match="sp_train"):
        chip_smoke.main(["bogus"])


def test_grad_spy_captures_then_compares(monkeypatch):
    """sp_train's GradSpy: kept grads on the host, then each later run's
    worst leaf as ‖g − g_ref‖/‖g_ref‖; the optimizer update still runs."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)

    class Tx:
        def __init__(self):
            self.calls = 0

        def update(self, model, grads, state):
            self.calls += 1
            return True

    g = {"a": torch.ones(4), "b": torch.full((2,), 2.0)}
    tx = Tx()
    spy = chip_smoke.GradSpy(tx, keep=1)
    assert tx.update(None, g, None) and tx.update(None, g, None)
    assert len(spy.grads) == 1 and torch.equal(spy.grads[0]["b"], g["b"])
    tx2 = Tx()
    cmp = chip_smoke.GradSpy(tx2, ref=spy.grads, keep=1)
    tx2.update(None, {"a": torch.ones(4), "b": torch.tensor([2.0, 2.2])}, None)
    rel, name = cmp.worst[0]
    assert name == "b" and abs(rel - 0.2 / (8.0 ** 0.5)) < 1e-6


def test_adafactor_reference_matches_optax():
    """The adafactor phase's f64 reference (`_adafactor_reference`, on the
    port's per-layer [d_out, d_in] parameters) against optax.adafactor and
    JAX's lr-scaled decay on the stacked leaf, second update: a factored
    [2, 128, 256] kernel and an unfactored [2, 64] bias."""
    jax = pytest.importorskip("jax")
    import numpy as np
    import optax

    from omnivideo_tpu.training.trainer import _lr_scaled_decay

    rng = np.random.default_rng(0)
    lr, wd = 1e-3, 0.01
    for shape, weight in (((2, 128, 256), True), ((2, 64), False)):
        p = rng.standard_normal(shape).astype(np.float32) * 0.02
        g0, g1 = (rng.standard_normal(shape).astype(np.float32) * 1e-3 for _ in range(2))
        tx = optax.chain(optax.adafactor(learning_rate=lr), _lr_scaled_decay(wd, lambda c: lr))
        st = tx.init(p)
        up, st = tx.update(g0, st, p)
        p1 = np.asarray(optax.apply_updates(p, up))
        fac = st[0][0]
        up, _ = tx.update(g1, st, p1)
        want = np.asarray(up, np.float64)
        names = [f"blocks.{i}.x.weight" if weight else f"blocks.{i}.x.bias" for i in range(2)]
        port = (lambda a: torch.tensor(a).T) if weight else torch.tensor
        p0 = {n: port(p1[i]) for i, n in enumerate(names)}
        g = {n: port(g1[i]) for i, n in enumerate(names)}
        if weight:
            state = {k: {n: torch.tensor(np.asarray(getattr(fac, k))[i])
                         for i, n in enumerate(names)} for k in ("v_row", "v_col")}
        else:
            state = {"v": {n: torch.tensor(np.asarray(fac.v)[i]) for i, n in enumerate(names)}}
        got = chip_smoke._adafactor_reference(names, p0, g, state, 1, 1.0, lr, wd).numpy()
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-5, shape


def test_fingerprint_sees_one_element():
    """The lora phase's base check: one flipped element, even in its low
    bits, changes the fingerprint."""
    t = torch.randn(1000)
    f = chip_smoke._fingerprint(t)
    u = t.clone()
    u[517] = torch.nextafter(u[517], torch.tensor(float("inf")))
    assert torch.equal(chip_smoke._fingerprint(t.clone()), f)
    assert not torch.equal(chip_smoke._fingerprint(u), f)


def test_sft_batch_and_stand_in_chat_data(tmp_path):
    """The sft phases' data: `_sft_batch` rows of unequal target counts,
    padded at the tail (the --sp forward has no mask); and the stand-in
    tokenizer's ChatML data through sft_tokenize (no chat_template: rendered
    natively), whose labels keep the assistant turns and their <|im_end|>."""
    from omnivideo_tpu_torch.tools.data_prepare.sft_tokenize import tokenize_dataset
    from omnivideo_tpu_torch.training.conversation import ConversationDataset
    from omnivideo_tpu_torch.training.sft import SFTDataset

    cfg = chip_smoke.dataclasses.replace(chip_smoke.SFT_MESH_CFG, vocab_size=300)
    b = chip_smoke._sft_batch(cfg, 2, 64, 9, lens=[64, 40], device="cpu")
    assert b["ids"].shape == b["labels"].shape == b["attn_mask"].shape == (2, 64)
    assert b["attn_mask"].sum(1).tolist() == [64, 40]
    assert ((b["labels"] != -100).sum(1)).tolist() == [64 - 21, 40 - 13]
    conv = tmp_path / "c.jsonl"
    conv.write_text('{"conversations": [{"from": "human", "value": "hi"}, '
                    '{"from": "gpt", "value": "ok"}]}')
    tokenize_dataset(ConversationDataset(str(conv), chip_smoke.StandInTokenizer()),
                     str(tmp_path / "d"))
    s = SFTDataset(str(tmp_path / "d"))[0]
    kept = [int(i) for i, lab in zip(s["ids"], s["labels"]) if lab != -100]
    assert kept == [*b"ok", 151645, *b"\n"]
