"""The check for JAX compares whole top-level module names."""

from kws_bench import harness


def test_whole_top_level_names():
    mods = {"speech_recognition_tpu_torch": 1,
            "speech_recognition_tpu_torch.models.zoo": 1,
            "jaxtyping": 1, "flaxen": 1, "numpy": 1}
    assert harness.forbidden_loaded(mods) == []
    mods.update({"jax.numpy": 1, "jaxlib": 1, "flax.linen": 1,
                 "speech_recognition_tpu.ops": 1})
    assert harness.forbidden_loaded(mods) == [
        "flax.linen", "jax.numpy", "jaxlib", "speech_recognition_tpu.ops"]


def test_no_module_of_the_benchmark_imports_jax_or_the_port():
    import ast
    for path in harness.PACKAGE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                top = n.split(".")[0]
                assert top not in harness.FORBIDDEN_MODULES, (path, n)
                if "reference" in path.parts:
                    assert top != "speech_recognition_tpu_torch", (path, n)
