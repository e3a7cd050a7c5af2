"""What the benchmark loads: never JAX nor the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference nothing of the port."""

import json
import subprocess
import sys

from perfbench.run import FORBIDDEN, ROOT

PORT = "pytorch_distributed_example_tpu_torch"


def top_level_modules(code: str) -> set:
    probe = code + ("\nimport sys, json\n"
                    "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    mods = top_level_modules(
        "import perfbench.run, perfbench.calibrate\n"
        "from perfbench import spec\n"
        "spec.kind_module('dense_decoder'); spec.reference_module('dense_decoder')\n"
        "for n in ('host_ms', 'gemm_ms', 'pointwise_ms', 'flash_ms', 'flash_roofline',"
        " 'adamw_ms', 'device_idle', 'step_mfu', 'train_tokens_per_s', 'peak_mem',"
        " 'setup_s'): spec.metric_reader(n)\n")
    assert PORT in mods
    assert not mods & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    mods = top_level_modules("import perfbench.reference.dense_decoder, perfbench.feed, "
                             "perfbench.layouts.dense_decoder, perfbench.check, perfbench.flops")
    assert not mods & {PORT, *FORBIDDEN}


def test_no_source_reads_the_jax_packages_benchmarks():
    for path in (ROOT / "perfbench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        assert "benchmarks/" not in text, path
        assert "import jax" not in text and "from jax" not in text, path
