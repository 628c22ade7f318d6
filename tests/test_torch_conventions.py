"""Source-level conventions of the port that its numerics depend on.

The torch analogue of `tests/test_conventions.py`. On the card a float32
matrix product (`torch.einsum`, `matmul`, `mm`, `bmm`, `@`) rounds its
inputs to TF32 whenever the process turns TF32 on
(`torch.backends.cuda.matmul.allow_tf32`,
`torch.set_float32_matmul_precision("high")`): about 5e-4 relative, which
costs millimetres in the soft-argmax decode after the 2200 mm box scale.
So the port's device code has no matrix product outside the allow-list
below, each entry with its reason; the int8 product `torch._int_mm` counts
as one too, so that every matrix product of the device code is listed. The convolutions go through cuDNN and
follow `model.matmul_precision` (`config.apply_matmul_precision`).
`geom/camera.py` is not device code: it works on numpy on the host. Nor are
the host input pipeline's modules in `HOST_FILES`: they import no torch, and
their products are numpy's, in float64, which never round to TF32.
"""
import ast
import pathlib

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "metro_pose3d_tpu_torch"
DEVICE_DIRS = ("ops", "models", "evaluation", "pipeline", "train", "probes")
DEVICE_MODULES = ("multiperson.py",)  # device code at the package's top level
PRODUCTS = {"einsum", "matmul", "mm", "bmm", "_int_mm"}
# host numpy modules in those directories (the crop algebra, the loader)
HOST_FILES = {"pipeline/crops.py", "pipeline/loader.py", "train/joint_mapping.py"}

# (file under the package, enclosing function) -> why the product may stay
ALLOWED = {
    ("probes/prims.py", "rowsel_plain"):
        "exact at any precision: one-hot rows times integers below 256, the "
        "plain twin of the tensor-core row select, on no path",
    ("ops/int8.py", "int_products"):
        "integer sums, exact at any TF32 setting: int8 x int8 -> int32 by "
        "torch._int_mm, for QK1's plain twin only (the CPU path and the card's "
        "checks); on the card every int8 conv, 1x1 included, runs QK1",
}


def _products(tree: ast.AST):
    """-> [(line, enclosing function, what)] for every matrix product."""
    found = []

    def visit(node, func):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            func = node.name
        what = None
        if isinstance(node, (ast.BinOp, ast.AugAssign)) and isinstance(node.op, ast.MatMult):
            what = "@"
        elif isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
            if name in PRODUCTS:
                what = name
        if what:
            found.append((node.lineno, func, what))
        for child in ast.iter_child_nodes(node):
            visit(child, func)

    visit(tree, None)
    return found


def _device_files():
    return sorted([p for d in DEVICE_DIRS for p in (PKG / d).rglob("*.py")
                   if p.relative_to(PKG).as_posix() not in HOST_FILES]
                  + [PKG / m for m in DEVICE_MODULES])


def test_host_files_import_no_torch():
    for rel in HOST_FILES:
        tree = ast.parse((PKG / rel).read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert not [m for m in names if m.split(".")[0] == "torch"], rel


def test_no_matrix_product_in_device_code_outside_the_allow_list():
    offenders, used = [], set()
    for path in _device_files():
        rel = path.relative_to(PKG).as_posix()
        for line, func, what in _products(ast.parse(path.read_text())):
            if (rel, func) in ALLOWED:
                used.add((rel, func))
            else:
                offenders.append(f"metro_pose3d_tpu_torch/{rel}:{line} {what} in {func}")
    assert not offenders, (
        "matrix products in device code round to TF32 when the process turns it on; "
        "write them as float32 products and sums, or allow-list them with a reason:\n"
        + "\n".join(offenders))
    assert used == set(ALLOWED), f"allow-list entries that match nothing: {set(ALLOWED) - used}"


@pytest.mark.parametrize("src,want", [
    ("def f(a, b):\n    return torch.einsum('ij,jk->ik', a, b)\n", [(2, "f", "einsum")]),
    ("def g(a, b):\n    return a @ b\n", [(2, "g", "@")]),
    ("def h(a, b):\n    a @= b\n    return a.mm(b) + torch.bmm(a, b)\n",
     [(2, "h", "@"), (3, "h", "mm"), (3, "h", "bmm")]),
    ("@staticmethod\ndef k(a):\n    '''a @ b in a docstring'''\n    return a  # x @ y\n", []),
    ("x = torch.matmul(a, b)\n", [(1, None, "matmul")]),
    ("def q(a, b):\n    return torch._int_mm(a, b)\n", [(2, "q", "_int_mm")]),
], ids=["einsum", "matmul_operator", "inplace_mm_bmm", "decorator_docstring_comment",
        "module_level", "int_mm"])
def test_the_lint_finds_products_and_only_products(src, want):
    assert _products(ast.parse(src)) == want
