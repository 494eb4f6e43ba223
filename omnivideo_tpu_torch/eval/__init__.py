"""Benchmark evaluation: the VQA adapters, scoring modes and aggregates
(eval/vqa.py), grounding (eval/grounding.py) and pairwise judging
(eval/pairwise.py); driven by
omnivideo_tpu_torch/tools/eval_vlm.py."""

from .vqa import (  # noqa: F401
    ADAPTERS,
    adapt_rows,
    aggregate,
    build_prompt,
    evaluate,
    mme_scores,
    normalize_answer,
    pope_metrics,
    score_row,
)
