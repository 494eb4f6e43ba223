"""Pairwise answer-quality judging, GPT-review style (the port's own copy of
omnivideo_tpu/eval/pairwise.py, pure Python).

Role of reference `previous_version/Omni-Video1/nets/third_party/llava/eval/
eval_gpt_review*.py` (two assistants' answers scored 1-10 by a judge model,
first line of the review = "score1 score2"): the judge is an INJECTED
callable `judge_fn(prompt) -> str`, so the harness carries no API dependency
— wire an LLM client in production, a stub in tests. Parsing and aggregation
mirror the reference (`parse_score`, win/tie/loss + relative score).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

_SYSTEM = ("You are a helpful and precise assistant for checking the "
           "quality of the answer.")

_RULE = (
    "We would like to request your feedback on the performance of two AI "
    "assistants in response to the user question displayed above.\n"
    "Please rate the helpfulness, relevance, accuracy, level of details of "
    "their responses. Each assistant receives an overall score on a scale "
    "of 1 to 10, where a higher score indicates better overall performance.\n"
    "Please first output a single line containing only two values indicating "
    "the scores for Assistant 1 and 2, respectively. The two scores are "
    "separated by a space. In the subsequent line, please provide a "
    "comprehensive explanation of your evaluation."
)


def build_review_prompt(question: str, answer1: str, answer2: str,
                        context: Optional[str] = None) -> str:
    """The review request (reference eval_gpt_review.py content assembly:
    context + question + both answers + rule)."""
    parts = []
    if context:
        parts.append(f"[Context]\n{context}\n")
    parts += [
        f"[Question]\n{question}\n",
        f"[Assistant 1]\n{answer1}\n[End of Assistant 1]\n",
        f"[Assistant 2]\n{answer2}\n[End of Assistant 2]\n",
        f"[System]\n{_RULE}\n",
    ]
    return "\n".join(parts)


def parse_score_pair(review: str) -> Tuple[float, float]:
    """First line "7 8" → (7.0, 8.0); malformed → (-1, -1)
    (reference parse_score, eval_gpt_review.py:45-59)."""
    try:
        first = review.strip().split("\n")[0].replace(",", " ")
        vals = [v for v in first.split(" ") if v]
        if len(vals) == 2:
            return float(vals[0]), float(vals[1])
    except (ValueError, IndexError):
        pass
    return -1.0, -1.0


def pairwise_review(
    rows: List[Dict],
    judge_fn: Callable[[str], str],
    system_prompt: str = _SYSTEM,
) -> Tuple[List[Dict], Dict]:
    """Judge answer pairs; returns (per-row results, aggregate).

    rows: dicts with question, answer1, answer2, optional context/category.
    judge_fn: prompt -> review text. The system prompt is prepended to the
    prompt text (single-string judges); API-client wrappers can split it.
    """
    results = []
    for i, row in enumerate(rows):
        prompt = build_review_prompt(
            row["question"], row["answer1"], row["answer2"],
            context=row.get("context"))
        review = judge_fn(f"{system_prompt}\n\n{prompt}")
        s1, s2 = parse_score_pair(review)
        results.append({
            "question_id": row.get("question_id", i),
            "category": row.get("category"),
            "score1": s1,
            "score2": s2,
            "review": review,
            "valid": s1 >= 0 and s2 >= 0,
        })

    valid = [r for r in results if r["valid"]]
    n = len(valid)
    wins2 = sum(r["score2"] > r["score1"] for r in valid)
    ties = sum(r["score2"] == r["score1"] for r in valid)
    avg1 = sum(r["score1"] for r in valid) / n if n else 0.0
    avg2 = sum(r["score2"] for r in valid) / n if n else 0.0
    summary = {
        "n": len(results),
        "n_valid": n,
        "avg_score1": avg1,
        "avg_score2": avg2,
        # the reference reports assistant-2-relative quality (review tables)
        "relative_score": (avg2 / avg1) if avg1 > 0 else 0.0,
        "win2": wins2,
        "tie": ties,
        "loss2": n - wins2 - ties,
    }
    return results, summary
