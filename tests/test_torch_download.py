"""The port's model download / search / list (`convert/download.py`, `cli
download / search / list`): the cases of `tests/test_download.py` on the
port, and the JAX package's alias table; nothing is fetched."""

import os
import sys

import pytest

from mnn_tpu.convert import download as jdl
from mnn_tpu_torch import cli
from mnn_tpu_torch.convert import download as dl


def test_alias():
    assert dl.resolve("qwen2-0.5b") == "Qwen/Qwen2-0.5B-Instruct"
    assert dl.resolve("QWEN2-0.5B") == "Qwen/Qwen2-0.5B-Instruct"
    assert dl.ALIASES == jdl.ALIASES


def test_passthrough():
    assert dl.resolve("some/Other-Repo") == "some/Other-Repo"


def test_list_local(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MNN_TPU_MODELS_DIR", str(tmp_path))
    (tmp_path / "a-model").mkdir()
    (tmp_path / "a-model" / "config.json").write_text("{}")
    (tmp_path / "b-model").mkdir()
    (tmp_path / "b-model" / "model.safetensors").write_bytes(b"")
    (tmp_path / "not-a-model").mkdir()
    assert dl.list_local() == ["a-model", "b-model"] == jdl.list_local()
    cli.main(["list"])
    assert capsys.readouterr().out.split() == ["a-model", "b-model"]


def test_models_dir_env(tmp_path, monkeypatch):
    monkeypatch.setenv("MNN_TPU_MODELS_DIR", str(tmp_path / "md"))
    assert dl.models_dir() == str(tmp_path / "md")
    assert os.path.isdir(dl.models_dir())


def test_download_failure_is_actionable(tmp_path, monkeypatch):
    monkeypatch.setenv("MNN_TPU_MODELS_DIR", str(tmp_path))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    with pytest.raises(RuntimeError, match="no network egress|failed"):
        dl.download("qwen2-0.5b")
    with pytest.raises(RuntimeError, match="no network egress|failed"):
        cli.main(["download", "qwen2-0.5b", "--out", str(tmp_path / "q")])


def test_without_huggingface_hub(tmp_path, monkeypatch):
    """The card's machine has no huggingface_hub: download and search say
    so; list needs nothing."""
    monkeypatch.setenv("MNN_TPU_MODELS_DIR", str(tmp_path))
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match="huggingface_hub"):
        dl.download("qwen2-0.5b")
    with pytest.raises(RuntimeError, match="huggingface_hub"):
        dl.search("qwen")
    assert dl.list_local() == []
