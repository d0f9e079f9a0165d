"""The JAX repository's scripts (examples/refscale_*.py, the root bench.py)
as namespaces for the port's tests, without running what they do when
imported: their top-level calls (the path insert, the persistent
compilation cache they switch on through jax.config) and their `from
bench import ...` (bench.py switches that cache on when imported) are left
out, so loading one changes no jax.config. The module constants can then
be set small; each function reads them from the namespace."""

import ast
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_CACHE_OPTIONS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
                     "jax_persistent_cache_min_entry_size_bytes")


def _kept(node) -> bool:
    if isinstance(node, ast.ImportFrom) and node.module == "bench":
        return False
    if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
        return False
    return not isinstance(node, ast.If)  # the __main__ block


def load_script(rel: str, **consts) -> dict:
    """The namespace of the repository's script `rel` ("bench.py",
    "examples/refscale_frame.py"), `consts` set in it."""
    path = ROOT / rel
    tree = ast.parse(path.read_text(), filename=str(path))
    ns = {"__name__": rel[:-3].replace("/", "."), "__file__": str(path)}
    exec(compile(ast.Module([n for n in tree.body if _kept(n)], []), str(path), "exec"), ns)
    ns.update(consts)
    return ns


def load_example(name: str, **consts) -> dict:
    """The namespace of examples/<name>.py, `consts` set in it."""
    return load_script(f"examples/{name}.py", **consts)


def nested_function(ns: dict, outer: str, name: str, **closure):
    """A function defined inside `outer` of a loaded script, with the
    names it reads from `outer`'s scope given as `closure`."""
    path = pathlib.Path(ns["__file__"])
    tree = ast.parse(path.read_text(), filename=str(path))
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == outer)
    inner = next(n for n in ast.walk(fn) if isinstance(n, ast.FunctionDef) and n.name == name)
    scope = {**ns, **closure}
    exec(compile(ast.Module([inner], []), str(path), "exec"), scope)
    return scope[name]


def jax_cache_options():
    import jax

    return {k: getattr(jax.config, k) for k in JAX_CACHE_OPTIONS}
