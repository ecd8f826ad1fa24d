"""Import guard for the PyTorch port: ``src/repro_torch`` and
``chip_smoke.py`` import neither JAX nor the JAX package ``repro``, and
importing the port's serving, RWKV training, and lanes / quantization /
FHE paths leaves ``jax`` out of ``sys.modules``."""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:[.\s,]|$)", re.M)


def test_port_sources_import_no_jax_and_no_reference_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    offenders = {str(f.relative_to(ROOT)): FORBIDDEN.findall(f.read_text())
                 for f in files}
    assert {f: m for f, m in offenders.items() if m} == {}
    # the pattern itself catches what it must, and spares the port
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from repro.core import attention")
    assert not FORBIDDEN.search("from repro_torch.core import attention")


def test_importing_the_serve_path_loads_no_jax():
    """The serving path, its telemetry and serve analyzer, and the
    ``blocked`` inhibitor backend its planner may pick on the CPU."""
    code = ("import sys; sys.path.insert(0, 'src'); "
            "import repro_torch.launch.serve, repro_torch.serve.engine, "
            "repro_torch.serve.telemetry, repro_torch.analysis, "
            "repro_torch.convert, repro_torch.kernels.ops, "
            "repro_torch.core.blocked; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_importing_the_rwkv_train_path_loads_no_jax():
    code = ("import sys; sys.path.insert(0, 'src'); "
            "import repro_torch.models.rwkv, repro_torch.kernels.rwkv6, "
            "repro_torch.launch.train, repro_torch.launch.profile, "
            "repro_torch.models.registry; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_importing_the_lanes_and_fhe_stack_loads_no_jax():
    code = ("import sys; sys.path.insert(0, 'src'); "
            "import repro_torch.core.lanes, repro_torch.quant, "
            "repro_torch.fhe, repro_torch.launch.fhe, "
            "repro_torch.nn.lane_layers; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _loads_no_jax(modules: str, extra: str = "") -> None:
    code = ("import sys; sys.path.insert(0, 'src'); "
            f"import {modules}; {extra}"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_importing_the_static_analyzer_loads_no_jax():
    """The interval domain and lane, the analyzer, its CLI and the lint,
    and the interval lane through the lane factory."""
    _loads_no_jax("repro_torch.analysis, repro_torch.analysis.__main__, "
                  "repro_torch.analysis.lint, repro_torch.core.lanes",
                  "repro_torch.core.lanes.get_lane('interval'); ")


def test_importing_the_checkpoint_path_loads_no_jax():
    """The checkpoint store and manager, the train loop and launchers
    that resume from them, and the Prefetcher."""
    _loads_no_jax("repro_torch.checkpoint, repro_torch.train.loop, "
                  "repro_torch.launch.train_inhibitor_lm, "
                  "repro_torch.data.pipeline")


def test_importing_and_running_the_serve_analyzer_loads_no_jax():
    """The cost model, the serve analyzer's CLI, and one analysis of the
    reduced rwkv6-7b engine (built, its steps walked on meta tensors)."""
    _loads_no_jax("repro_torch.analysis.costmodel, "
                  "repro_torch.analysis.serve",
                  "from repro_torch.analysis.serve_static import "
                  "analyze_serve; analyze_serve('rwkv6-7b', reduced={}, "
                  "engine_kw=dict(max_batch=2, max_len=16, page_size=8, "
                  "prefill_chunk=4)); ")


def test_importing_the_moe_and_hybrid_families_loads_no_jax():
    """The MoE layer, the Mamba half of nn.ssm, every ported config, and
    one reduced qwen2-moe and hymba step through the registry."""
    _loads_no_jax(
        "repro_torch.nn.moe, repro_torch.nn.ssm, repro_torch.configs, "
        "repro_torch.models.registry, torch",
        "from repro_torch.configs import ARCH_IDS, get_config; "
        "from repro_torch.models.registry import get_model; "
        "[get_config(a) for a in ARCH_IDS]; "
        "cfgs = [get_config(a).reduced() for a in ('qwen2-moe-a2.7b', "
        "'hymba-1.5b')]; "
        "[get_model(c).forward(get_model(c).init(torch.Generator()"
        ".manual_seed(0), device='cpu'), {'tokens': torch.zeros((1, 4), "
        "dtype=torch.int64)}) for c in cfgs]; ")


def test_importing_the_encdec_vlm_and_conv_modules_loads_no_jax():
    """The encoder-decoder, the conv layers, the two new configs, and one
    reduced seamless forward and decode step and one llava forward with
    image embeddings through the registry."""
    _loads_no_jax(
        "repro_torch.models.encdec, repro_torch.nn.conv, "
        "repro_torch.configs.seamless_m4t_large_v2, "
        "repro_torch.configs.llava_next_mistral_7b, "
        "repro_torch.models.registry, torch",
        "from repro_torch.configs import get_config; "
        "from repro_torch.models.registry import get_model; "
        "g = torch.Generator().manual_seed(0); "
        "s = get_config('seamless-m4t-large-v2').reduced(); "
        "api = get_model(s); p = api.init(g, device='cpu'); "
        "api.forward(p, {'frames': torch.zeros((1, 8, 32)), "
        "'tokens': torch.zeros((1, 4), dtype=torch.int64)}); "
        "api.step(p, torch.zeros((1, 1), dtype=torch.int64), "
        "api.init_states(1, 8, device='cpu'), "
        "{'memory': torch.zeros((1, 8, 64))}); "
        "v = get_config('llava-next-mistral-7b').reduced(); "
        "api = get_model(v); "
        "api.forward(api.init(g, device='cpu'), {'tokens': torch.zeros("
        "(1, 4), dtype=torch.int64), 'image_embeds': torch.zeros("
        "(1, 16, 32))}); ")


def test_importing_the_distributed_layer_loads_no_jax():
    """The sharding rules, collectives, pipeline, the mesh, shardings and
    dry-run launchers, the Param box and gradient compression, and the
    spec of one full-width parameter tree on the production mesh."""
    _loads_no_jax(
        "repro_torch.distributed, repro_torch.distributed.sharding, "
        "repro_torch.distributed.collectives, "
        "repro_torch.distributed.pipeline, repro_torch.distributed.fault, "
        "repro_torch.launch.mesh, repro_torch.launch.shardings, "
        "repro_torch.launch.dryrun, repro_torch.nn.module, "
        "repro_torch.optim.compress, torch",
        "from repro_torch.configs import get_config; "
        "from repro_torch.models.registry import get_model; "
        "from repro_torch.distributed.sharding import AbstractMesh; "
        "from repro_torch.launch.shardings import params_shardings; "
        "from repro_torch.nn.module import box_like; "
        "api = get_model(get_config('smollm-135m')); "
        "params_shardings(box_like(api.init(torch.Generator(), "
        "device='meta'), api.axes()), AbstractMesh((16, 16), "
        "('data', 'model'))); ")
