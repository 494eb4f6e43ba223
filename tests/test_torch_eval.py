"""The port's evaluation side against the JAX package on the CPU:

- eval/vqa.py, eval/grounding.py and eval/pairwise.py: every adapter on the
  same native rows, every scoring mode on the same (row, prediction) pairs,
  the engine's results and each format's aggregates, the grounding parser
  and IoU, and the pairwise review with the same stub judge give equal
  outputs (the same pure-Python arithmetic; exact);
- `smart_nframes` equals JAX's; `fetch_video` samples the same frames at
  the same fps and resizes them on the device within 1 uint8 level of
  JAX's Pillow resize on these down- and moderate upscales (a 3x upscale
  reads 2 levels on ~1e-6 of the values, the rounding of Pillow's
  fixed-point taps); `preprocess_video` (a second resize to the patch grid)
  gives JAX's grid and patches within 2 levels (one level of the first
  resize carried by the bicubic taps, whose absolute sum exceeds 1), more
  than 1 level on at most 1e-4 of the values (measured ~1e-5);
- tools/eval_vlm.py end to end on a tiny Qwen3-VL checkpoint dir
  (tests/torch_io_tiny.py, patch 16, f32) over image and video rows, one of
  them multiple-choice: the same predictions, scores and summary as JAX's
  tools/eval_vlm.py answer function on the same dir (inputs at their
  target sizes, so no resize runs in either package).
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_io_tiny import write_qwen3vl_hf_dir

from omnivideo_tpu.eval import grounding as j_grounding
from omnivideo_tpu.eval import pairwise as j_pairwise
from omnivideo_tpu.eval import vqa as j_vqa
from omnivideo_tpu.models.qwen3vl import preprocess as j_pre
from omnivideo_tpu.utils import qwen_vl_media as j_media
from omnivideo_tpu_torch.eval import grounding, pairwise, vqa
from omnivideo_tpu_torch.models.qwen3vl import media, preprocess
from omnivideo_tpu_torch.tools import eval_vlm
from omnivideo_tpu_torch.utils.png import write_png

REPO = Path(__file__).resolve().parents[1]
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711])  # per channel

NATIVE = {
    "generic": [{"question_id": 1, "text": "Is it red?", "answer": "yes", "category": "c"},
                {"question_id": 2, "text": "Shape?", "options": ["square", "B. circle"],
                 "answer": "A"}],
    "pope": [{"question_id": 3, "text": "Is there a cat?", "label": "no", "image": "a.png"},
             {"question_id": 4, "question": "A dog?", "answer": "yes", "category": "adv"}],
    "mme": [{"question_id": 5, "text": "Is it blue?", "answer": "Yes", "image": "b.png",
             "category": "color"},
            {"question_id": 6, "question": "Is it red?", "answer": "No", "image": "b.png",
             "category": "color"}],
    "videomme": [{"qid": 7, "question": "What happens?", "videoID": "v.npz",
                  "options": ["A. runs", "B. sits", "(C) jumps"], "answer": "B",
                  "duration": "short"}],
    "mmmu": [{"id": 8, "question": "Pick", "image_1": "c.png",
              "options": ["a", "b", "c", "d", "e", "f", "g"], "answer": "G",
              "subfield": "math"}],
    "scienceqa": [{"id": 9, "question": "Which?", "choices": ["x", "y"], "answer": 1,
                   "subject": "bio"}],
    "textvqa": [{"question_id": 10, "question": "Sign text?",
                 "answers": ["stop", "stop", "STOP", "go"]}],
    "chartqa": [{"qid": 11, "query": "Value?", "label": "37.5"},
                {"qid": 12, "query": "Name?", "label": "Alpha"},
                {"qid": 13, "query": "Zero?", "label": "0"}],
    "docvqa": [{"questionId": 14, "question": "Date?", "answers": ["march 3", "3 march"]}],
    "gqa": [{"id": 15, "question": "Color?", "imageId": "g1", "answer": "red",
             "types": {"semantic": "attr"}},
            {"id": 16, "question": "Left?", "answer": "no", "category": "rel"}],
    "vizwiz": [{"question_id": 17, "question": "What is it?",
                "answers": [{"answer": "cup"}, {"answer": "mug"}, "cup"],
                "answer_type": "other"}],
    "mathvista": [{"pid": 18, "query": "Which?", "choices": ["1", "2.5", "three"],
                   "answer": "2.5", "question_type": "multi_choice"},
                  {"pid": 19, "question": "How many?", "answer": "7", "answer_type": "integer"},
                  {"pid": 20, "question": "Ratio?", "answer": "0.333", "answer_type": "float",
                   "precision": 2, "metadata": {"category": "alg"}},
                  {"pid": 21, "question": "Word?", "answer": "Blue"}],
    "refcoco": [{"img_id": 22, "sents": "the left cup", "bbox": [10, 20, 30, 40],
                 "image": "r.png", "dataset": "refcoco+"},
                {"question_id": 23, "sentence": "a box", "bbox": [1, 2, 50, 60],
                 "bbox_format": "xyxy"}],
}
PREDICTIONS = ["yes", "Yes, it is.", "no", "The answer is B.", "(A)", "G", "stop", "Stop!",
               "37", "37.5", "alpha", "0", "march 3rd", "3 march", "2.5", "B", "7.2", "0.33",
               "blue", "cup", "[10, 20, 40, 60]", "(12,22),(38,58)", "x1=1 y1=2 x2=50 y2=60",
               "", "Unanswerable"]


@pytest.mark.parametrize("fmt", sorted(NATIVE))
def test_adapters_scores_and_aggregates_equal_jax(fmt):
    assert list(vqa.ADAPTERS) == list(j_vqa.ADAPTERS)
    rows, j_rows = vqa.adapt_rows(NATIVE[fmt], fmt), j_vqa.adapt_rows(NATIVE[fmt], fmt)
    assert rows == j_rows
    for row in rows:
        assert vqa.build_prompt(row) == j_vqa.build_prompt(row)
        for p in PREDICTIONS:
            assert vqa.score_row(row, p) == j_vqa.score_row(row, p), (row, p)
    for k in range(len(PREDICTIONS)):
        answer = (lambda r, k=k: PREDICTIONS[(k + len(str(r.get("question_id")))) %
                                             len(PREDICTIONS)])
        got = vqa.evaluate(vqa.adapt_rows(NATIVE[fmt], fmt), answer, fmt=fmt)
        assert got == j_vqa.evaluate(j_vqa.adapt_rows(NATIVE[fmt], fmt), answer, fmt=fmt)
    with pytest.raises(SystemExit, match="unknown --format"):
        vqa.adapt_rows([], "nope")


def test_pope_mme_aggregates_and_grounding_equal_jax():
    results = [{"prediction": p, "answer": a, "category": c, "image": i, "score": s}
               for p, a, c, i, s in (("yes", "yes", "x", "1", 1.0), ("no", "yes", "x", "1", 0.0),
                                     ("Yes.", "no", "y", "2", 0.0), ("no", "no", "y", "2", 1.0),
                                     ("yes", "yes", "y", "3", 1.0))]
    assert vqa.pope_metrics(results) == j_vqa.pope_metrics(results)
    assert vqa.mme_scores(results) == j_vqa.mme_scores(results)
    assert vqa.aggregate(results) == j_vqa.aggregate(results)
    assert grounding.grounding_accuracy(results) == j_grounding.grounding_accuracy(results)
    for text in PREDICTIONS + ["box 1.5 2 -3 4.25", "x1 x2"]:
        assert grounding.parse_box(text) == j_grounding.parse_box(text)
    for a, b in (([0, 0, 10, 10], [5, 5, 15, 15]), ([0, 0, 1, 1], [3, 3, 4, 4]),
                 ([2, 2, 2, 2], [2, 2, 2, 2])):
        assert grounding.box_iou(a, b) == j_grounding.box_iou(a, b)


def test_pairwise_review_equals_jax():
    rows = [{"question": f"q{i}", "answer1": "a", "answer2": "b", "category": "c",
             **({"context": "ctx"} if i % 2 else {})} for i in range(5)]
    reviews = iter(["7 8\nwhy", "5, 5\n", "garbage", "9 3", "6 6.5 7"] * 2)
    judge = lambda prompt: next(reviews)  # noqa: E731
    got = pairwise.pairwise_review(rows, judge)
    assert got == j_pairwise.pairwise_review(rows, judge)
    assert got[1]["n_valid"] == 3 and got[1]["win2"] == 1
    assert pairwise.build_review_prompt("q", "a", "b", "c") == \
        j_pairwise.build_review_prompt("q", "a", "b", "c")


@pytest.mark.parametrize("ele,total,fps", [
    ({}, 48, 24.0), ({"fps": 4}, 48, 24.0), ({"nframes": 7}, 48, 24.0),
    ({"min_frames": 6, "max_frames": 10}, 200, 30.0), ({}, 9, 2.0), ({"fps": 0.5}, 600, 30.0),
])
def test_smart_nframes_equals_jax(ele, total, fps):
    assert media.smart_nframes(ele, total, fps) == j_media.smart_nframes(ele, total, fps)


def test_smart_nframes_refusals_equal_jax():
    for ele, total in (({"fps": 2, "nframes": 4}, 10), ({"nframes": 12}, 10), ({}, 1)):
        with pytest.raises(ValueError):
            media.smart_nframes(ele, total, 8.0)
        with pytest.raises(ValueError):
            j_media.smart_nframes(ele, total, 8.0)


def _levels(a, b):
    """|a − b| of two patch sets in uint8 levels of each value's channel."""
    c = np.abs(a - b).reshape(a.shape[0], 3, -1)
    return c * 255 * CLIP_STD[None, :, None]


@pytest.mark.parametrize("shape,fps,ele", [
    ((9, 600, 760, 3), 8, {}),  # down to 588x756
    ((6, 200, 300, 3), 3, {}),  # up to 280x392
    ((12, 90, 140, 3), 5, {"min_pixels": 28 * 28 * 4, "max_pixels": 28 * 28 * 64}),
    ((8, 112, 168, 3), 4, {"nframes": 4}),  # no resize
])
def test_fetch_and_preprocess_video_equal_jax(tmp_path, shape, fps, ele):
    path = tmp_path / "clip.npz"
    np.savez(path, frames=np.random.default_rng(len(ele) + shape[1]).integers(
        0, 256, shape, dtype=np.uint8), fps=fps)
    ele = {"video": str(path), **ele}
    got, got_fps = media.fetch_video(ele, device="cpu")
    ref, ref_fps = j_media.fetch_video(ele)
    assert got.shape == ref.shape and got.dtype == np.uint8 and got_fps == ref_fps
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    if "min_pixels" in ele:
        return
    p, grid = preprocess.preprocess_video(str(path), patch_size=16, device="cpu",
                                          nframes=ele.get("nframes"))
    rp, rgrid = j_pre.preprocess_video(str(path), patch_size=16, nframes=ele.get("nframes"))
    assert grid == rgrid and p.shape == rp.shape
    lv = _levels(p, rp)
    assert lv.max() <= 2.0 + 1e-4 and (lv > 1.0 + 1e-4).mean() <= 1e-4


def test_process_vision_info(tmp_path):
    img = np.random.default_rng(4).integers(0, 256, (60, 90, 3), dtype=np.uint8)
    write_png(tmp_path / "i.png", img)
    np.savez(tmp_path / "v.npz", frames=np.zeros((8, 56, 56, 3), np.uint8), fps=4)
    msgs = [{"role": "system", "content": "text only"},
            {"role": "user", "content": [{"image": f"file://{tmp_path / 'i.png'}"},
                                         {"video": str(tmp_path / "v.npz")},
                                         {"type": "text", "text": "hi"}]}]
    images, videos = media.process_vision_info(msgs, device="cpu")
    h, w = media.smart_resize(60, 90)
    assert [i.shape for i in images] == [(h, w, 3)] and images[0].dtype == np.uint8
    assert len(videos) == 1 and videos[0].shape[0] == 4
    assert media.process_vision_info([{"role": "user", "content": "x"}], "cpu") == (None, None)


@pytest.fixture(scope="module")
def vqa_dir(tmp_path_factory):
    d = write_qwen3vl_hf_dir(tmp_path_factory.mktemp("eval_hf"), patch_size=16,
                             transformers=False)
    cfg = json.loads((d / "config.json").read_text())
    (d / "config.json").write_text(json.dumps({**cfg, "model_type": "qwen3_vl"}))
    rng = np.random.default_rng(5)
    write_png(d / "img.png", rng.integers(0, 256, (64, 96, 3), dtype=np.uint8))
    np.savez(d / "clip.npz", frames=rng.integers(0, 256, (8, 448, 448, 3), dtype=np.uint8),
             fps=4)
    rows = [{"question_id": 0, "text": "tok1 yes", "image": "img.png", "answer": "yes",
             "category": "img"},
            {"question_id": 1, "text": "tok2 no", "video": "clip.npz", "answer": "no",
             "category": "vid"},
            {"question_id": 2, "text": "tok3", "video": "clip.npz", "options": ["tok4", "tok5"],
             "answer": "A", "category": "vid"}]
    (d / "q.jsonl").write_text("\n".join(json.dumps(r) for r in rows))
    return d


def _jax_eval_vlm():
    spec = importlib.util.spec_from_file_location("jax_eval_vlm", REPO / "tools/eval_vlm.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("jax_eval_vlm", mod)
    spec.loader.exec_module(mod)
    return mod


def test_eval_vlm_end_to_end_equals_jax(vqa_dir, tmp_path):
    report = tmp_path / "r.json"
    args = eval_vlm.parse_args(["--model_path", str(vqa_dir), "--questions",
                                str(vqa_dir / "q.jsonl"), "--report", str(report),
                                "--max_new_tokens", "3", "--device", "cpu"])
    results, summary = eval_vlm.run(args)
    assert json.loads(report.read_text())["summary"] == summary
    assert summary["n"] == 3 and set(summary) == {"accuracy", "n", "per_category"}
    jmod = _jax_eval_vlm()
    rows = eval_vlm.load_rows(str(vqa_dir / "q.jsonl"), "generic")
    # the MC row widens max_new_tokens to 12 in both tools
    j_results, j_summary = jmod.evaluate(rows, jmod.make_jax_answer_fn(str(vqa_dir), 12))
    assert [r["prediction"] for r in results] == [r["prediction"] for r in j_results]
    assert results == j_results and summary == j_summary
    assert any(r["prediction"] for r in results)
