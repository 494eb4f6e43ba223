"""MLLM benchmark evaluation library: format adapters + scoring + aggregates
(the port's own copy of omnivideo_tpu/eval/vqa.py, pure Python).

Role of the reference's llava/eval benchmark scripts
(previous_version/.../llava/eval/: model_vqa_videomme.py, eval_mmmu.py,
eval_pope.py, eval_science_qa.py, eval_textvqa.py, m4c_evaluator.py, ...):
the reference ships one ad-hoc script per benchmark. Here one
engine (omnivideo_tpu_torch/tools/eval_vlm.py drives the port's Qwen3-VL
greedy decode), and this library holds what actually differs per
benchmark —

  * a row ADAPTER that maps the benchmark's native record shape onto one
    canonical row {question_id, text, image/video, answer, category, mode,
    answers?}
  * a scoring MODE: "open" (normalized exact/prefix match — MME/POPE),
    "mc" (multiple-choice letter extraction — VideoMME/MMMU/ScienceQA),
    "vqa_soft" (VQAv2 consensus min(matches/3, 1) — TextVQA),
    "relaxed" (±5% numeric tolerance — ChartQA),
    "anls" (normalized-Levenshtein similarity, 0.5 floor — DocVQA)
  * benchmark AGGREGATES beyond plain accuracy: POPE precision/recall/F1/
    yes-ratio, MME acc+acc+ per-category score.
"""

from __future__ import annotations

import re
import string
from typing import Callable, Dict, List, Optional

# ---------------------------------------------------------------- normalize


def normalize_answer(text: str) -> str:
    """Lowercase, strip punctuation/articles/whitespace."""
    text = str(text).strip().lower()
    text = text.translate(str.maketrans("", "", string.punctuation))
    text = re.sub(r"\b(a|an|the)\b", " ", text)
    return re.sub(r"\s+", " ", text).strip()


def _extract_choice_letter(prediction: str, n_options: int = 5) -> str:
    """First standalone option letter in a free-form model answer.

    Accepts 'A', '(A)', 'A.', 'A)', 'The answer is A', 'Answer: A.' — the
    same liberal extraction the reference's videomme/mmmu parsers do.
    """
    letters = string.ascii_uppercase[:n_options]
    m = re.search(rf"\b([{letters}])\b", prediction.strip().upper())
    return m.group(1) if m else ""


# ------------------------------------------------------------------ scoring


def score_open(prediction: str, truth: str) -> bool:
    """MME/POPE-style: normalized equality, or truth as the leading word(s)
    of the prediction ('yes, it is' matches 'yes')."""
    p, t = normalize_answer(prediction), normalize_answer(truth)
    if not t:
        return not p
    return p == t or p.startswith(t + " ") or (p.split(" ") or [""])[0] == t


def score_mc(prediction: str, truth: str, n_options: int = 5) -> bool:
    return _extract_choice_letter(prediction, n_options) == str(truth).strip().upper()


def score_vqa_soft(prediction: str, answers: List[str]) -> float:
    """VQAv2 consensus accuracy: min(#annotators agreeing / 3, 1)."""
    p = normalize_answer(prediction)
    matches = sum(normalize_answer(a) == p for a in answers)
    return min(matches / 3.0, 1.0)


def score_relaxed(prediction: str, truth: str, tol: float = 0.05) -> bool:
    """ChartQA relaxed accuracy: numeric answers match within ±5%, strings
    by normalized equality (ref eval/eval_chartqa semantics). Numbers are
    extracted from the RAW strings — normalize_answer strips the decimal
    point ('37.5' → '375')."""
    num = r"-?\d+(?:\.\d+)?"
    tm = re.fullmatch(num, str(truth).strip().rstrip("%"))
    if tm:
        pm = re.findall(num, str(prediction))
        if not pm:
            return False
        pv, tv = float(pm[-1]), float(tm.group())
        if tv == 0:
            return pv == 0
        return abs(pv - tv) / abs(tv) <= tol
    return normalize_answer(prediction) == normalize_answer(truth)


def _lev(a: str, b: str) -> int:
    """Levenshtein edit distance (iterative two-row)."""
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def score_anls(prediction: str, truth_list: List[str],
               threshold: float = 0.5) -> float:
    """DocVQA ANLS: 1 − normalized Levenshtein to the closest ground truth,
    floored to 0 below the 0.5 threshold."""
    p = normalize_answer(prediction)
    lev = _lev
    best = 0.0
    for t in truth_list:
        t = normalize_answer(t)
        denom = max(len(p), len(t), 1)
        s = 1.0 - lev(p, t) / denom
        best = max(best, s)
    return best if best >= threshold else 0.0


_NUM_RE = r"[-+]?\d[\d,]*\.?\d*"


def score_mathvista(prediction: str, row: Dict) -> float:
    """MathVista answer normalization + exact compare (role of reference
    mathvista_utils/calculate_score.py `normalize_extracted_answer` +
    `safe_equal`): multi_choice snaps to the edit-distance-closest choice
    (or the choice named by a bare option letter); integer/float answers
    are parsed and rounded to the row's precision; everything else is
    normalized-string equality."""
    choices = row.get("choices") or []
    ans = str(row.get("answer", "")).strip()
    pred = str(prediction).strip()
    if row.get("question_type") == "multi_choice" or (choices and not row.get("answer_type")):
        if pred not in choices:
            letter = _extract_choice_letter(pred, len(choices))
            if letter and ord(letter) - 65 < len(choices):
                pred = choices[ord(letter) - 65]
            else:
                pred = min(choices, key=lambda c: _lev(pred, str(c))) if choices else pred
        return float(str(pred) == ans)
    at = row.get("answer_type")
    m = re.search(_NUM_RE, pred.replace(",", ""))
    if at == "integer":
        try:
            return float(int(round(float(m.group()))) == int(round(float(ans))))
        except (AttributeError, ValueError):
            return 0.0
    if at == "float":
        prec = int(row.get("precision") or 2)
        try:
            return float(round(float(m.group()), prec) == round(float(ans), prec))
        except (AttributeError, ValueError):
            return 0.0
    return float(normalize_answer(pred) == normalize_answer(ans))


def score_row(row: Dict, prediction: str) -> float:
    mode = row.get("mode", "open")
    if mode == "mc":
        # use the row's real option count — MMMU has up to 9 options, and a
        # fixed A–E window could never score F–I correct (ADVICE r2)
        n_opts = max(len(row.get("options") or ()), 5)
        return float(score_mc(prediction, row["answer"], n_opts))
    if mode == "vqa_soft":
        return score_vqa_soft(prediction, row.get("answers") or [row.get("answer", "")])
    if mode == "relaxed":
        return float(score_relaxed(prediction, str(row.get("answer", ""))))
    if mode == "anls":
        return score_anls(prediction, row.get("answers") or [row.get("answer", "")])
    if mode == "grounding":
        from .grounding import score_grounding

        return score_grounding(prediction, row["answer"])
    if mode == "mathvista":
        return score_mathvista(prediction, row)
    return float(score_open(prediction, str(row.get("answer", row.get("label", "")))))


# ------------------------------------------------------- prompt construction

_MC_SUFFIX = "Answer with the option's letter from the given choices directly."
_YN_SUFFIX = "Answer the question using a single word or phrase."


def build_prompt(row: Dict) -> str:
    """The question text handed to the model, options included for MC."""
    q = row.get("text", row.get("question", ""))
    opts = row.get("options")
    if row.get("mode") == "mc" and opts:
        lines = [q] + list(opts) + [_MC_SUFFIX]
        return "\n".join(lines)
    return q


# ------------------------------------------------------------- row adapters
# Each adapter: native record dict -> canonical row. Canonical keys:
#   question_id, text, image|video (path or None), answer, category,
#   mode ("open"|"mc"|"vqa_soft"), options (ready "A. xxx" strings), answers.


def _fmt_options(opts: List[str]) -> List[str]:
    out = []
    for i, o in enumerate(opts):
        o = str(o).strip()
        letter = string.ascii_uppercase[i]
        # native VideoMME options already carry "A. " prefixes; MMMU's don't
        if not re.match(rf"^\(?{letter}[\).: ]", o):
            o = f"{letter}. {o}"
        out.append(o)
    return out


def adapt_generic(r: Dict) -> Dict:
    row = dict(r)
    row.setdefault("mode", "mc" if r.get("options") else "open")
    if row.get("options"):
        row["options"] = _fmt_options(row["options"])
    return row


def adapt_pope(r: Dict) -> Dict:
    return {
        "question_id": r.get("question_id"),
        "text": f"{r.get('text', r.get('question', ''))} {_YN_SUFFIX}".strip(),
        "image": r.get("image"),
        "answer": r.get("label", r.get("answer", "")),
        "category": r.get("category", "pope"),
        "mode": "open",
    }


def adapt_mme(r: Dict) -> Dict:
    return {
        "question_id": r.get("question_id"),
        "text": r.get("text", r.get("question", "")),
        "image": r.get("image"),
        "answer": r.get("answer", ""),
        "category": r.get("category", "mme"),
        "mode": "open",
    }


def adapt_videomme(r: Dict) -> Dict:
    return {
        "question_id": r.get("question_id", r.get("qid")),
        "text": r.get("question", r.get("text", "")),
        "video": r.get("video", r.get("videoID")),
        "options": _fmt_options(r.get("options", [])),
        "answer": r.get("answer", ""),
        "category": r.get("duration", r.get("category", "videomme")),
        "mode": "mc",
    }


def adapt_mmmu(r: Dict) -> Dict:
    return {
        "question_id": r.get("id", r.get("question_id")),
        "text": r.get("question", r.get("text", "")),
        "image": r.get("image", r.get("image_1")),
        "options": _fmt_options(r.get("options", [])),
        "answer": r.get("answer", ""),
        "category": r.get("subfield", r.get("category", "mmmu")),
        "mode": "mc",
    }


def adapt_scienceqa(r: Dict) -> Dict:
    choices = r.get("choices", r.get("options", []))
    ans = r.get("answer", "")
    if isinstance(ans, int):  # native ScienceQA stores the index
        ans = string.ascii_uppercase[ans]
    return {
        "question_id": r.get("question_id", r.get("id")),
        "text": r.get("question", r.get("text", "")),
        "image": r.get("image"),
        "options": _fmt_options(choices),
        "answer": ans,
        "category": r.get("subject", r.get("category", "scienceqa")),
        "mode": "mc",
    }


def adapt_gqa(r: Dict) -> Dict:
    return {
        "question_id": r.get("question_id", r.get("id")),
        "text": f"{r.get('question', r.get('text', ''))} {_YN_SUFFIX}".strip(),
        "image": r.get("image", r.get("imageId")),
        "answer": r.get("answer", ""),
        "category": r.get("types", {}).get("semantic", "gqa")
        if isinstance(r.get("types"), dict) else r.get("category", "gqa"),
        "mode": "open",
    }


def adapt_vizwiz(r: Dict) -> Dict:
    answers = [a.get("answer", a) if isinstance(a, dict) else a
               for a in (r.get("answers") or [])]
    return {
        "question_id": r.get("question_id"),
        "text": (f"{r.get('question', r.get('text', ''))} When the provided "
                 "information is insufficient, respond with 'Unanswerable'. "
                 + _YN_SUFFIX).strip(),
        "image": r.get("image"),
        "answer": answers[0] if answers else r.get("answer", ""),
        "answers": answers,
        "category": r.get("answer_type", r.get("category", "vizwiz")),
        "mode": "vqa_soft",
    }


def adapt_chartqa(r: Dict) -> Dict:
    return {
        "question_id": r.get("question_id", r.get("qid")),
        "text": f"{r.get('query', r.get('question', r.get('text', '')))} {_YN_SUFFIX}".strip(),
        "image": r.get("image", r.get("imgname")),
        "answer": r.get("label", r.get("answer", "")),
        "category": r.get("category", "chartqa"),
        "mode": "relaxed",
    }


def adapt_docvqa(r: Dict) -> Dict:
    answers = r.get("answers") or ([r["answer"]] if r.get("answer") else [])
    return {
        "question_id": r.get("questionId", r.get("question_id")),
        "text": f"{r.get('question', r.get('text', ''))} {_YN_SUFFIX}".strip(),
        "image": r.get("image"),
        "answer": answers[0] if answers else "",
        "answers": answers,
        "category": r.get("category", "docvqa"),
        "mode": "anls",
    }


def adapt_mathvista(r: Dict) -> Dict:
    """MathVista record (pid/question/choices/answer/answer_type/precision,
    reference mathvista_utils) → canonical row."""
    choices = r.get("choices") or []
    return {
        "question_id": r.get("pid", r.get("question_id")),
        "text": r.get("query", r.get("question", "")),
        "image": r.get("image"),
        "answer": r.get("answer", ""),
        "choices": choices,
        "question_type": r.get("question_type",
                               "multi_choice" if choices else "free_form"),
        "answer_type": r.get("answer_type"),
        "precision": r.get("precision"),
        "category": r.get("metadata", {}).get("category", "mathvista")
        if isinstance(r.get("metadata"), dict) else "mathvista",
        "mode": "mathvista",
    }


def adapt_textvqa(r: Dict) -> Dict:
    answers = r.get("answers") or ([r["answer"]] if r.get("answer") else [])
    return {
        "question_id": r.get("question_id"),
        "text": f"{r.get('question', r.get('text', ''))} {_YN_SUFFIX}".strip(),
        "image": r.get("image"),
        "answer": answers[0] if answers else "",
        "answers": answers,
        "category": r.get("category", "textvqa"),
        "mode": "vqa_soft",
    }


ADAPTERS: Dict[str, Callable[[Dict], Dict]] = {
    "generic": adapt_generic,
    "pope": adapt_pope,
    "mme": adapt_mme,
    "videomme": adapt_videomme,
    "mmmu": adapt_mmmu,
    "scienceqa": adapt_scienceqa,
    "textvqa": adapt_textvqa,
    "chartqa": adapt_chartqa,
    "docvqa": adapt_docvqa,
    "gqa": adapt_gqa,
    "vizwiz": adapt_vizwiz,
    "mathvista": adapt_mathvista,
}

# grounding lives in eval/grounding.py (refcoco family; reference
# eval_refcoco.py) but plugs into the same registry/scorer
from .grounding import adapt_refcoco  # noqa: E402

ADAPTERS["refcoco"] = adapt_refcoco


def adapt_rows(rows: List[Dict], fmt: str) -> List[Dict]:
    try:
        adapter = ADAPTERS[fmt]
    except KeyError:
        raise SystemExit(f"unknown --format {fmt!r}; one of {sorted(ADAPTERS)}")
    return [adapter(r) for r in rows]


# --------------------------------------------------------------- aggregates


def _score_of(r: Dict) -> float:
    return float(r["score"] if "score" in r else r.get("correct", 0.0))


def aggregate(results: List[Dict]) -> Dict:
    """results: [{question_id, prediction, answer, category, score}] →
    {accuracy, n, per_category}. score is in [0, 1] (soft modes included);
    boolean "correct" keys are accepted as 0/1 scores."""
    n = len(results)
    acc = sum(_score_of(r) for r in results) / n if n else 0.0
    per_cat: Dict[str, List[float]] = {}
    for r in results:
        per_cat.setdefault(r.get("category") or "all", []).append(_score_of(r))
    return {
        "accuracy": round(acc, 4),
        "n": n,
        "per_category": {c: round(sum(v) / len(v), 4)
                         for c, v in sorted(per_cat.items())},
    }


def pope_metrics(results: List[Dict]) -> Dict:
    """POPE hallucination metrics: precision/recall/F1 on 'yes', yes-ratio
    (ref eval_pope.py prints exactly these four)."""
    tp = fp = tn = fn = yes = 0
    for r in results:
        pred_yes = (normalize_answer(r["prediction"]).split(" ") or [""])[0] == "yes"
        true_yes = normalize_answer(str(r["answer"])) == "yes"
        yes += pred_yes
        if pred_yes and true_yes:
            tp += 1
        elif pred_yes and not true_yes:
            fp += 1
        elif not pred_yes and true_yes:
            fn += 1
        else:
            tn += 1
    n = max(len(results), 1)
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    return {
        "precision": round(prec, 4),
        "recall": round(rec, 4),
        "f1": round(f1, 4),
        "yes_ratio": round(yes / n, 4),
    }


def mme_scores(results: List[Dict]) -> Dict:
    """MME per-category score = 100·(acc + acc+), where acc+ counts images
    with BOTH of their paired questions answered correctly (ref
    eval/MME/calculation.py semantics). Pairs share an image path."""
    by_cat: Dict[str, Dict[str, List[Dict]]] = {}
    for r in results:
        cat = r.get("category") or "all"
        img = str(r.get("image"))
        by_cat.setdefault(cat, {}).setdefault(img, []).append(r)
    out = {}
    for cat, imgs in sorted(by_cat.items()):
        flat = [r for rs in imgs.values() for r in rs]
        acc = sum(_score_of(r) for r in flat) / max(len(flat), 1)
        acc_plus = sum(
            all(_score_of(r) >= 1.0 for r in rs) for rs in imgs.values()
        ) / max(len(imgs), 1)
        out[cat] = round(100 * (acc + acc_plus), 2)
    out["total"] = round(sum(v for k, v in out.items() if k != "total"), 2)
    return out


# ------------------------------------------------------------------- engine


def evaluate(rows: List[Dict], answer_fn: Callable[[Dict], str],
             fmt: str = "generic") -> (List[Dict], Dict):
    """Run answer_fn over canonical rows, score per mode, aggregate.

    answer_fn receives the canonical row (use build_prompt(row) for the
    final question text) and returns the model's free-form answer string.
    """
    results = []
    for row in rows:
        pred = answer_fn(row)
        s = score_row(row, pred)
        results.append({
            "question_id": row.get("question_id", len(results)),
            "prediction": pred,
            "answer": row.get("answer", row.get("label", "")),
            "category": row.get("category"),
            "image": row.get("image"),
            "score": s,
            "correct": s >= 1.0,
        })
    summary = aggregate(results)
    if fmt == "pope":
        summary["pope"] = pope_metrics(results)
    if fmt == "mme":
        summary["mme_score"] = mme_scores(results)
    if fmt == "refcoco":
        from .grounding import grounding_accuracy

        summary["grounding"] = grounding_accuracy(results)
    return results, summary
