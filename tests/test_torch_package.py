"""Package-level checks of the PyTorch port: it stands alone (no jax, no
whisper_tpu module), its copied host modules agree with the originals, and
its entry points default to CUDA and refuse to fall back to the CPU."""

import ast
import io
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "whisper_tpu_torch"

SLICE_MODULES = [
    "whisper_tpu_torch",
    "whisper_tpu_torch.hparams",
    "whisper_tpu_torch.ggml",
    "whisper_tpu_torch.vocab",
    "whisper_tpu_torch.languages",
    "whisper_tpu_torch.config",
    "whisper_tpu_torch.model.params",
    "whisper_tpu_torch.model.layers",
    "whisper_tpu_torch.model.encoder",
    "whisper_tpu_torch.model.decoder",
    "whisper_tpu_torch.model.omni_params",
    "whisper_tpu_torch.model.omni",
    "whisper_tpu_torch.model.longcat_params",
    "whisper_tpu_torch.model.longcat",
    "whisper_tpu_torch.kernels.attention",
    "whisper_tpu_torch.kernels.decode_attention",
    "whisper_tpu_torch.kernels.w8a16",
    "whisper_tpu_torch.kernels.moe",
    "whisper_tpu_torch.kernels.mla",
    "whisper_tpu_torch.kernels.quant",
    "whisper_tpu_torch.kernels.kbench",
    "whisper_tpu_torch.tools.kbench",
    "whisper_tpu_torch.runtime.sampler",
    "whisper_tpu_torch.runtime.decode",
    "whisper_tpu_torch.runtime.context",
    "whisper_tpu_torch.runtime.beam",
    "whisper_tpu_torch.runtime.graph",
    "whisper_tpu_torch.runtime.batch",
    "whisper_tpu_torch.runtime.omni",
    "whisper_tpu_torch.runtime.longcat",
    "whisper_tpu_torch.features.mel",
    "whisper_tpu_torch.features.stream",
    "whisper_tpu_torch.api.params",
    "whisper_tpu_torch.api.result",
    "whisper_tpu_torch.api.timestamps",
    "whisper_tpu_torch.api.diarize",
    "whisper_tpu_torch.api.context",
    "whisper_tpu_torch.api.model",
    "whisper_tpu_torch.obs.profiler",
    "whisper_tpu_torch.audio.load",
    "whisper_tpu_torch.cli.writers",
    "whisper_tpu_torch.cli.main",
    "whisper_tpu_torch.cli.serve",
    "whisper_tpu_torch.audio",
    "whisper_tpu_torch.audio.capture",
    "whisper_tpu_torch.audio.vad",
    "whisper_tpu_torch.features",
    "whisper_tpu_torch.features.filters",
    "whisper_tpu_torch.model",
    "whisper_tpu_torch.kernels",
    "whisper_tpu_torch.tools.synthetic",
    "whisper_tpu_torch.tools.compare_traces",
    "whisper_tpu_torch.tools.convert_hf_to_ggml",
    "whisper_tpu_torch.obs.trace",
    "whisper_tpu_torch.obs.nandebug",
    "whisper_tpu_torch.obs.logging",
    "whisper_tpu_torch.api.devices",
    "whisper_tpu_torch._language_data",
    "whisper_tpu_torch.api",
    "whisper_tpu_torch.cli",
    "whisper_tpu_torch.kernels._build",
    "whisper_tpu_torch.obs",
    "whisper_tpu_torch.runtime",
    "whisper_tpu_torch.tools",
    "whisper_tpu_torch.parallel",
    "whisper_tpu_torch.parallel.group",
    "whisper_tpu_torch.parallel.mesh",
    "whisper_tpu_torch.parallel.sharding",
    "whisper_tpu_torch.parallel.launch",
    "whisper_tpu_torch.native",
    "whisper_tpu_torch.audio.ffdecode",
]


def test_import_leaves_out_jax_and_whisper_tpu():
    """In a fresh interpreter (this one already imported jax in conftest)."""
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'whisper_tpu' or m.startswith('whisper_tpu.'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_every_port_module_is_in_the_import_check():
    """Each module of the port is imported by the fresh-interpreter check
    above."""
    names = {".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
             for p in PORT.rglob("*.py")}
    assert names <= set(SLICE_MODULES), sorted(names - set(SLICE_MODULES))


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_source_imports_no_jax_or_whisper_tpu(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "whisper_tpu"), f"{path}: imports {name}"


def _imported(path):
    """Every module ``path`` names in an import statement, at any depth:
    ``from a import b`` gives ``a.b``."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield from (f"{node.module}.{a.name}" for a in node.names)


ABOVE_KERNELS = tuple(f"whisper_tpu_torch.{pkg}" for pkg in ("model", "runtime", "api", "cli"))


@pytest.mark.parametrize(
    "path",
    sorted((PORT / "kernels").glob("*.py")) + [PORT / "runtime" / "graph.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_kernel_layer_imports_nothing_above_it(path):
    """The kernel layer imports nothing of the model, runtime, api or cli
    packages; the runtime's graph module takes from it only the build and
    the launch ledger (``kernels._build``), no wrapper."""
    for name in _imported(path):
        if path.parent.name == "kernels":
            assert not any(name == p or name.startswith(p + ".") for p in ABOVE_KERNELS), \
                f"{path}: imports {name}"
        elif name.startswith("whisper_tpu_torch.kernels"):
            assert name.startswith("whisper_tpu_torch.kernels._build."), f"{path}: imports {name}"


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    import torch

    from whisper_tpu_torch.api.model import Model, load_model
    from whisper_tpu_torch.cli.main import build_parser, main
    from whisper_tpu_torch.cli.serve import main as serve_main
    from whisper_tpu_torch.runtime.context import WhisperRuntime

    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        Model(str(tmp_path / "missing.bin"))
    with pytest.raises(RuntimeError, match="cuda"):
        load_model(str(tmp_path / "missing.bin"))
    with pytest.raises(RuntimeError, match="cuda"):
        WhisperRuntime(None, None, None)
    assert build_parser().parse_args(["-m", "m", "-f", "a.wav"]).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        main(["-m", str(tmp_path / "missing.bin"), "-f", "a.wav"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve_main([str(tmp_path / "missing.bin"), "--port", "0"])


def test_ggml_writer_bytes_match_jax_package():
    """The streaming writer emits exactly the JAX package's bytes, and the
    filterbank copy equals the original."""
    from tests.helpers import TINY_TEST_DIMS, make_vocab_words, random_weights
    from whisper_tpu import ggml as jg
    from whisper_tpu.features.filters import mel_filter_bank as jax_filters
    from whisper_tpu_torch import ggml as tg

    filters = tg.mel_filter_bank(80)
    np.testing.assert_array_equal(filters, jax_filters(80))
    words = make_vocab_words(TINY_TEST_DIMS.n_vocab)[:300]
    weights = random_weights(TINY_TEST_DIMS, seed=4)
    bufs = []
    for mod in (jg, tg):
        buf = io.BytesIO()
        mod.write_checkpoint(buf, TINY_TEST_DIMS, mod.MelFilters(80, 201, filters), words, weights)
        bufs.append(buf.getvalue())
    assert bufs[0] == bufs[1]


def test_weights_int8_policy_raises(tmp_path):
    """The serving tier's entry points default to the card like the rest:
    without one, ``DtypePolicy.serving()`` and ``kv_int8`` raise rather than
    fall back; asked for the CPU, the decoder's weights load as int8."""
    import torch

    from tests.helpers import TINY_TEST_DIMS, make_random_checkpoint
    from whisper_tpu_torch.api.model import load_model
    from whisper_tpu_torch.model.params import DtypePolicy
    from whisper_tpu_torch.runtime.context import WhisperRuntime

    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without a CUDA card")
    path = str(tmp_path / "tiny.bin")
    make_random_checkpoint(path, TINY_TEST_DIMS, seed=5)
    with pytest.raises(RuntimeError, match="cuda"):
        load_model(path, policy=DtypePolicy.serving())
    with pytest.raises(RuntimeError, match="cuda"):
        WhisperRuntime(None, None, None, kv_int8=True)
    params = load_model(path, policy=DtypePolicy.serving(), device="cpu").runtime.params
    assert params.dec.blocks[0].fc1_w.dtype == params.dec.tok.dtype == torch.int8
    assert params.dec.blocks[0].fc1_w_s.shape == (1, 4 * TINY_TEST_DIMS.n_text_state)
    assert params.enc.blocks[0].fc1_w.dtype == torch.bfloat16
