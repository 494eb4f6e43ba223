"""The finetune CLI refuses i2v-14B up front: its train step feeds the DiT
neither the first-frame latents `y` nor the CLIP tokens `clip_fea`, so an
i2v block would split a text-only context at its 257 image tokens and die
inside attention (JAX's finetune cannot train i2v either). The refusal is a
parser error naming the reason, before any data, model or step."""

import pytest

from omnivideo_tpu_torch.tools import finetune


def test_finetune_refuses_i2v_before_any_step(tmp_path, capsys):
    out = tmp_path / "ft"
    with pytest.raises(SystemExit) as exc:
        finetune.main(["--task", "i2v-14B", "--dummy_data", "--tiny", "--total_steps", "1",
                       "--device", "cpu", "--output_dir", str(out)])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "i2v" in err and "clip_fea" in err
    assert not out.exists()  # nothing written: no run config, data or checkpoint


@pytest.mark.parametrize("extra", [[], ["--layer_stream"], ["--lora_rank", "4"]])
def test_every_mode_refuses_i2v(extra):
    with pytest.raises(SystemExit):
        finetune.parse_args(["--task", "i2v-14B", "--dummy_data", "--tiny"] + extra)
    assert finetune.parse_args(["--task", "t2v-14B", "--dummy_data", "--tiny"] + extra)
