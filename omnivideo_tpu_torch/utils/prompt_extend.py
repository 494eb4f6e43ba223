"""Prompt extension service (port of omnivideo_tpu/utils/prompt_extend.py,
the role of the reference's `omnivideo/utils/prompt_extend.py`).

Expands terse user prompts into detailed cinematic captions before T2V
generation, through the DashScope API (retry ×4) or a local Qwen model.
The task- and language-keyed system prompts are pluggable: pass
`system_prompt=` explicitly, point `system_prompt_file` at a JSON
{task: {lang: prompt}} map, or rely on the built-in default. DashScope
needs network access and the `dashscope` package (imported when the
expander is built; without it the constructor raises, and the local Qwen
expander is the offline path). `QwenPromptExpander` runs the port's
Qwen3-VL engine (models/qwen3vl/engine.py `Qwen3VLEngine._generate`, greedy
decode on the card) on an HF checkpoint dir (`model_name`).
"""

from __future__ import annotations

import dataclasses
import json
import random
import sys
from typing import Optional

DEFAULT_EXPAND_SYS_PROMPT = {
    "en": (
        "You are a film director. Rewrite the user's prompt into a rich, "
        "filmable video caption: keep the original subjects and actions, add "
        "concrete visual detail (appearance, counts, environment), lighting "
        "(source, softness, angle), color tone, shot size, camera angle and "
        "composition, and describe how the motion unfolds over time. 60-200 "
        "words. Output only the rewritten prompt."
    ),
    "zh": (
        "你是一位电影导演。请在不改变原意（主体、动作）的前提下，将用户的"
        "prompt 改写为细节丰富、可拍摄的视频描述：补充主体外观与数量、环境"
        "细节、光源与光线强度/角度、色调、镜头尺寸、拍摄角度与构图，并描述"
        "动作随时间的展开。字数 60-200 字，只输出改写后的 prompt。"
    ),
}


@dataclasses.dataclass
class PromptOutput:
    """One expansion's result."""

    status: bool
    prompt: str
    seed: int
    system_prompt: str
    message: str

    def add_custom_field(self, key, value):
        setattr(self, key, value)


class PromptExpander:
    """Base expander: picks the system prompt and dispatches on images."""

    def __init__(self, model_name=None, task="t2v-A14B", is_vl=False,
                 system_prompt_file: Optional[str] = None, **kwargs):
        self.model_name = model_name
        self.task = task
        self.is_vl = is_vl
        self._prompt_map = None
        if system_prompt_file:
            self._prompt_map = json.load(open(system_prompt_file))

    def decide_system_prompt(self, tar_lang="en", prompt=None) -> str:
        if self._prompt_map is not None:
            entry = self._prompt_map.get(self.task, self._prompt_map.get("t2v-A14B", {}))
            if isinstance(entry, dict) and tar_lang in entry:
                return entry[tar_lang]
        return DEFAULT_EXPAND_SYS_PROMPT.get(tar_lang, DEFAULT_EXPAND_SYS_PROMPT["en"])

    def extend(self, prompt, system_prompt, seed=-1, **kwargs) -> PromptOutput:
        raise NotImplementedError

    def extend_with_img(self, prompt, system_prompt, image=None, seed=-1, **kwargs):
        raise NotImplementedError

    def __call__(self, prompt, system_prompt=None, tar_lang="en", image=None,
                 seed=-1, **kwargs) -> PromptOutput:
        if system_prompt is None:
            system_prompt = self.decide_system_prompt(tar_lang=tar_lang, prompt=prompt)
        if seed < 0:
            seed = random.randint(0, sys.maxsize)
        if image is not None and self.is_vl:
            return self.extend_with_img(prompt, system_prompt, image=image, seed=seed, **kwargs)
        if not self.is_vl:
            return self.extend(prompt, system_prompt, seed, **kwargs)
        raise NotImplementedError


class DashScopePromptExpander(PromptExpander):
    """DashScope API expander. Requires network access and the `dashscope`
    package."""

    def __init__(self, api_key=None, model_name=None, retry_times=4, **kwargs):
        super().__init__(model_name=model_name or "qwen-plus", **kwargs)
        try:
            import dashscope  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "dashscope is not installed (air-gapped environment?). Use "
                "QwenPromptExpander for local prompt extension."
            ) from e
        import dashscope

        if api_key:
            dashscope.api_key = api_key
        self._dashscope = dashscope
        self.retry_times = retry_times

    def extend(self, prompt, system_prompt, seed=-1, **kwargs) -> PromptOutput:
        messages = [
            {"role": "system", "content": system_prompt},
            {"role": "user", "content": prompt},
        ]
        exception = None
        for _ in range(self.retry_times):
            try:
                response = self._dashscope.Generation.call(
                    self.model_name, messages=messages, seed=seed,
                    result_format="message",
                )
                if response.status_code == 200:
                    expanded = response.output.choices[0].message.content
                    return PromptOutput(True, expanded.strip(), seed, system_prompt,
                                        json.dumps(response, ensure_ascii=False))
                exception = RuntimeError(str(response))
            except Exception as e:  # pragma: no cover - network path
                exception = e
        return PromptOutput(False, prompt, seed, system_prompt, str(exception))


class QwenPromptExpander(PromptExpander):
    """Local Qwen expander over the port's Qwen3-VL engine on the HF
    checkpoint dir `model_name` (backend "jax", JAX's name for the native
    path)."""

    def __init__(self, model_name=None, backend="jax", max_new_tokens=512, device="cuda",
                 **kwargs):
        super().__init__(model_name=model_name, **kwargs)
        from ..models.qwen3vl.engine import Qwen3VLEngine, VLMConfig

        self.engine = Qwen3VLEngine(VLMConfig(model_path=model_name, backend=backend,
                                              max_new_tokens=max_new_tokens, device=device))

    def extend(self, prompt, system_prompt, seed=-1, **kwargs) -> PromptOutput:
        messages = [
            {"role": "system", "content": [{"type": "text", "text": system_prompt}]},
            {"role": "user", "content": [{"type": "text", "text": prompt}]},
        ]
        try:
            expanded = self.engine._generate(messages)
            return PromptOutput(True, expanded, seed, system_prompt, "ok")
        except Exception as e:  # the caller gets the prompt back and the reason
            return PromptOutput(False, prompt, seed, system_prompt, str(e))

    def extend_with_img(self, prompt, system_prompt, image=None, seed=-1, **kwargs):
        messages = [
            {"role": "system", "content": [{"type": "text", "text": system_prompt}]},
            {"role": "user", "content": [
                {"type": "image", "image": image},
                {"type": "text", "text": prompt},
            ]},
        ]
        try:
            expanded = self.engine._generate(messages)
            return PromptOutput(True, expanded, seed, system_prompt, "ok")
        except Exception as e:  # the caller gets the prompt back and the reason
            return PromptOutput(False, prompt, seed, system_prompt, str(e))
