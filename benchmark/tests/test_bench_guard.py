"""The import guard: top-level names compared whole."""

import subprocess
import sys

from benchtools import BENCH, ROOT, TINY_CONFIG


def test_forbidden_names_are_compared_whole():
    from harness import forbidden_modules

    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "starky_bn254_tpu",
            "starky_bn254_tpu.stark", "starky_bn254_tpu_torch", "starky_bn254_tpu_torch.stark",
            "jaxtyping", "numpy"]
    assert forbidden_modules(mods) == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
                                       "starky_bn254_tpu", "starky_bn254_tpu.stark"]


def test_a_loaded_jax_package_stops_the_result(capsys):
    import run

    code = run.guarded_report({"checks": {}}, modules=["numpy", "starky_bn254_tpu.stark.prover"])
    out, err = capsys.readouterr()
    assert code != 0 and out == ""
    assert "starky_bn254_tpu.stark.prover" in err
    assert run.guarded_report({"checks": {}}, modules=["starky_bn254_tpu_torch.stark"]) == 0


def test_the_harness_and_the_program_load_no_jax():
    code = (f"import sys; sys.path[:0] = [{BENCH!r}, {ROOT!r}]\n"
            "import run, generator, judge, harness\n"
            "from programs.air import Program\n"
            f"Program({TINY_CONFIG!r}, 'cpu')\n"
            "import reference.g1_exp, reference.verify\n"
            "assert not harness.forbidden_modules(sys.modules), harness.forbidden_modules(sys.modules)\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd="/", timeout=300)
