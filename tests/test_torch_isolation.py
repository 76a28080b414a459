"""The port stands alone: paddle_tpu_torch and chip_smoke.py load neither
JAX nor anything of the JAX package, and chip_smoke.py gives no result
without a CUDA device or without the rest of the repository."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "paddle_tpu_torch")


def _banned(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu")


def _env(**extra):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update(extra)
    return env


def test_import_loads_no_jax_and_no_jax_package():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import paddle_tpu_torch, chip_smoke\n"
        "import paddle_tpu_torch.models.transformer\n"
        "import paddle_tpu_torch.inference.api\n"
        "import paddle_tpu_torch.optimizer, paddle_tpu_torch.backward\n"
        "import paddle_tpu_torch.contrib.mixed_precision\n"
        "import paddle_tpu_torch.layers.learning_rate_scheduler\n"
        "import paddle_tpu_torch.compiler, paddle_tpu_torch.ir\n"
        "import paddle_tpu_torch.ir.pipeline, paddle_tpu_torch.ir.passes\n"
        "import paddle_tpu_torch.ir.pattern, paddle_tpu_torch.ir.analyze\n"
        "import paddle_tpu_torch.ops.kernels_fused\n"
        "import paddle_tpu_torch.ops.kernels_image\n"
        "import paddle_tpu_torch.ops.kernels_detection\n"
        "import paddle_tpu_torch.layers.detection\n"
        "import paddle_tpu_torch.models.resnet\n"
        "import paddle_tpu_torch.inference.serving\n"
        "import paddle_tpu_torch.inference.transpiler\n"
        "import paddle_tpu_torch.testing.faults\n"
        "import paddle_tpu_torch.testing.models\n"
        "import paddle_tpu_torch.ops.kernels_cache\n"
        "import paddle_tpu_torch.inference.generation\n"
        "import paddle_tpu_torch.inference.generation.engine\n"
        "import paddle_tpu_torch.inference.generation.paging\n"
        "import paddle_tpu_torch.inference.generation.sampling\n"
        "import paddle_tpu_torch.inference.generation.spec\n"
        "import paddle_tpu_torch.inference.generation.predictor\n"
        "import paddle_tpu_torch.ops.kernels_rnn\n"
        "import paddle_tpu_torch.ops.kernels_search\n"
        "import paddle_tpu_torch.ops.kernels_control\n"
        "import paddle_tpu_torch.layers.rnn\n"
        "import paddle_tpu_torch.layers.control_flow\n"
        "import paddle_tpu_torch.contrib.decoder\n"
        "import paddle_tpu_torch.contrib.decoder.beam_search_decoder\n"
        "import paddle_tpu_torch.models.machine_translation\n"
        "import paddle_tpu_torch.staging, paddle_tpu_torch.elastic\n"
        "import paddle_tpu_torch.reader.data_loader\n"
        "import paddle_tpu_torch.reader.decorator\n"
        "import paddle_tpu_torch.ops.kernels_reader\n"
        "import paddle_tpu_torch.data_feeder, paddle_tpu_torch.lod_tensor\n"
        "import paddle_tpu_torch.metrics, paddle_tpu_torch.average\n"
        "import paddle_tpu_torch.nets, paddle_tpu_torch.ops.kernels_loss\n"
        "import paddle_tpu_torch.models.fit_a_line\n"
        "import paddle_tpu_torch.models.mnist, paddle_tpu_torch.models.vgg\n"
        "import paddle_tpu_torch.models.deepfm\n"
        "import paddle_tpu_torch.models.word2vec\n"
        "import paddle_tpu_torch.models.se_resnext\n"
        "import paddle_tpu_torch.models.recommender\n"
        "import paddle_tpu_torch.models.understand_sentiment\n"
        "import paddle_tpu_torch.models.stacked_lstm\n"
        "import paddle_tpu_torch.ops.kernels_crf\n"
        "import paddle_tpu_torch.dataset, paddle_tpu_torch.dataset.conll05\n"
        "import paddle_tpu_torch.models.label_semantic_roles\n"
        "import paddle_tpu_torch.ops.kernels_sequence\n"
        "import paddle_tpu_torch.layers.nn, paddle_tpu_torch.layers.tensor\n"
        "import paddle_tpu_torch.framework, paddle_tpu_torch.executor\n"
        "import paddle_tpu_torch.ops.kernels_tensor\n"
        "import paddle_tpu_torch.layers.io, paddle_tpu_torch.layers.ops\n"
        "import paddle_tpu_torch.place, paddle_tpu_torch.layer_helper\n"
        "import paddle_tpu_torch.utils.flags\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO, env=_env())
    assert r.returncode == 0, r.stdout + r.stderr


def _sources():
    for root, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(
    os.path.relpath(p, REPO) for p in _sources()))
def test_no_import_statement_names_jax_or_the_jax_package(path):
    """Also catches imports inside functions, which an import-time check
    would not run."""
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_banned(n) for n in names), (path, node.lineno, names)


def test_chip_smoke_gives_no_result_without_cuda():
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                       text=True, timeout=120, cwd=REPO,
                       env=_env(CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    (tmp_path / "chip_smoke.py").write_text(src)
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                       text=True, timeout=120, cwd=str(tmp_path), env=_env())
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
