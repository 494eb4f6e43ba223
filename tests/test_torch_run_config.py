"""The port's YAML run config (utils/run_config.py) against JAX's
(omnivideo_tpu/utils/run_config.py, PyYAML) on the CPU: the precedence
CLI-explicit > YAML > defaults, the unknown-key error and the prefix
resolution (JAX test_training.py's test_run_config_yaml_tier); the port's
PyYAML-free reader against yaml.safe_load on what JAX's dump_run_config
writes for finetune namespaces; the port's writer read back by
yaml.safe_load equal to JAX's file; and seeded flat mappings of awkward
scalars (quotes, '#', ': ', YAML 1.1 look-alikes, long folded strings)
both ways. Everything else raises, naming the line."""

import argparse
import math
import random
import string

import pytest
import yaml

from omnivideo_tpu.utils import run_config as jax_rc
from omnivideo_tpu_torch.tools import finetune
from omnivideo_tpu_torch.utils import run_config as rc


def _parser():
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None)
    p.add_argument("--lr", type=float, default=3e-6)
    p.add_argument("--total_steps", type=int, default=1000)
    p.add_argument("--task", default="t2v-1.3B")
    return p


def test_precedence_unknown_keys_and_prefixes(tmp_path):
    p = _parser()
    cfgf = tmp_path / "train.yaml"
    cfgf.write_text("lr: 1.0e-4\ntotal_steps: 50\n")
    argv = ["--config", str(cfgf), "--lr", "2e-5"]
    args = rc.apply_yaml_config(p.parse_args(argv), p, argv)
    assert args.lr == 2e-5 and args.total_steps == 50 and args.task == "t2v-1.3B"
    out = rc.dump_run_config(args, tmp_path / "run")
    assert out.name == "run_config.yaml"
    resolved = yaml.safe_load(out.read_text())
    assert resolved["lr"] == 2e-5 and resolved["total_steps"] == 50

    bad = tmp_path / "bad.yaml"
    bad.write_text("learning_rate: 1.0\n")
    with pytest.raises(SystemExit, match="unknown keys"):
        rc.apply_yaml_config(p.parse_args(["--config", str(bad)]), p, ["--config", str(bad)])

    argv3 = ["--config", str(cfgf), "--total", "77"]
    args3 = rc.apply_yaml_config(p.parse_args(argv3), p, argv3)
    assert args3.total_steps == 77 and args3.lr == 1e-4
    assert rc.explicit_cli_dests(p, argv3) == jax_rc.explicit_cli_dests(p, argv3)
    assert rc.apply_yaml_config(p.parse_args([]), p, []).lr == 3e-6  # no --config: a no-op


@pytest.mark.parametrize("argv", [
    ["--dummy_data", "--tiny", "--device", "cpu"],
    ["--lora_rank", "16", "--lora_alpha", "32", "--lora_targets", "self_attn/q", "ffn/fc1",
     "--optimizer", "adafactor", "--lr", "1e-4", "--trainable", "wan",
     "--output_dir", "outputs/a run with spaces/and a rather long path that PyYAML will fold"
                     " over two lines because it is longer than eighty columns"],
    ["--data_dirs", "t2v=/data/t2v", "i2i=/data/i2i: x", "--task_weights", "t2v=2",
     "--walltime", "3600.5", "--ckpt_dir", "yes", "--seed", "0"],
])
def test_finetune_namespaces_both_ways(tmp_path, argv):
    args = finetune.parse_args(argv)
    path = jax_rc.dump_run_config(args, tmp_path / "jax")
    text = path.read_text()
    assert rc.read_yaml(text) == yaml.safe_load(text) == vars(args)
    ours = rc.dump_run_config(args, tmp_path / "port").read_text()
    assert yaml.safe_load(ours) == yaml.safe_load(text)
    assert rc.read_yaml(ours) == vars(args)


def _scalar(rng):
    special = ["yes", "No", "on", "null", "~", "", " ", "1e-4", "1.0e-4", "0x1F", "012", "0b11",
               "1_000", "3:20", ".inf", "-.Inf", ".NaN", "t2v-1.3B", "a: b", "#x", "- x", "[a]",
               "'q'", '"d"', "x #y", "é ü", "tab\there", "two\nlines", "back\\slash", "-"]
    k = rng.random()
    if k < 0.35:
        return rng.choice(special)
    if k < 0.45:
        return rng.randint(-10**12, 10**12)
    if k < 0.55:
        return rng.choice([3e-6, 1e-5, 0.1, -2.5e30, 1e16, math.inf, 5e-324, 0.0])
    if k < 0.65:
        return rng.choice([True, False, None])
    alphabet = string.ascii_letters + string.digits + " _-./:#'\"\\!&*[]{},%@`~?|>=\t\né"
    return "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 120)))


def test_seeded_mappings_both_ways():
    rng = random.Random(0)
    for _ in range(300):
        d = {f"k{j}": ([_scalar(rng) for _ in range(rng.randint(0, 3))] if rng.random() < 0.2
                       else _scalar(rng)) for j in range(rng.randint(1, 6))}
        text = yaml.safe_dump(d, sort_keys=True, default_flow_style=False)
        assert repr(rc.read_yaml(text)) == repr(yaml.safe_load(text)), text
        assert repr(yaml.safe_load(rc.write_yaml(d))) == repr(yaml.safe_load(text)), d


def test_hand_written_files():
    text = ("# a run\nlr: 1.0e-4   # peak\nlora_targets: [self_attn/q, 'ffn/fc1']\n"
            "trainable:\n  - wan\n  - companions\nresume: yes\nwalltime: ~\nseed: 0x10\n")
    assert rc.read_yaml(text) == yaml.safe_load(text)
    assert rc.read_yaml("") is None and rc.read_yaml("# nothing\n") is None


@pytest.mark.parametrize("text,line", [
    ("lr: 1.0\nnested:\n  a: 1\n", 3),
    ("a: &x 1\nb: *x\n", 1),
    ("a: !!str 1\n", 1),
    ("a: |\n  block\n", 1),
    ("day: 2002-12-14\n", 1),
    ("a: 1\n---\nb: 2\n", 2),
    ("a:\n- [1, 2]\n", 2),
    ("a: 1\na: 2\n", 2),
])
def test_unsupported_yaml_names_the_line(text, line):
    with pytest.raises(rc.YAMLError, match=f"line {line}"):
        rc.read_yaml(text)
