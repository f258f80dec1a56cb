"""The port's inventory against the reference package, by syntax tree (no
import): every public top-level name, public method of a public class and
``add_argument`` flag of each ``src/repro/**.py`` is in the port's module
at the same path under ``src/repro_torch/``, renamed in :data:`RENAMED`,
or not carried, with its reason, in :data:`NOT_CARRIED`.  A name the port
module imports counts as present (it is reachable as ``module.name``).

The tables are held from both sides: each entry names a name the
reference has, a rename points at a name the port has, and a name listed
as not carried is really absent from the port.
"""
import ast
import pathlib

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

TILING = ("a Pallas block size; the port's tiles come from its .cu files' "
          "plans (gemm_plan, packed_plan, matmul_plan, smem_layout)")

# module -> {reference name: port name}; "module:name" is a name in
# another module of the port
RENAMED = {
    "kernels/attn_flash.py": {
        "attn_flash_pallas": "attn_flash",
        "attn_flash_xla": "attn_flash_plain",
        "attn_paged_pallas": "attn_paged",
        "attn_paged_xla": "attn_paged_plain"},
    "kernels/bitgemm.py": {"bitgemm_packed_pallas": "bitgemm_packed"},
    "kernels/bitgemm_mxu.py": {"int8_matmul_pallas": "int8_matmul"},
    "kernels/conv_implicit.py": {
        "conv_implicit_pallas": "conv_implicit",
        "conv_implicit_xla": "conv_implicit_plain"},
    "kernels/fused_qgemm.py": {"fused_qgemm_pallas": "fused_qgemm"},
    "api/__init__.py": {"HardwareTarget": "Target"},
    "kernels/quantpack.py": {"quantize_pack_pallas": "quantize_pack"},
    "api/targets.py": {
        "HardwareTarget": "Target",
        "AREA_MM2": "TABLE2_AREA_MM2",
        "ENERGY_SCALE": "TABLE2_ENERGY_SCALE",
        "PIM_CLOCK_GHZ": "pim/energy.py:CLOCK_GHZ"},
    "distributed/sharding.py": {"shardings_for": "tree_shardings"},
    "launch/hlo_analysis.py": {"ICI_BW": "NVLINK_BW"},
    "launch/engine.py": {
        "CNNRunner.make_forward": "CNNRunner.forward",
        "LMRunner.make_forward": "LMRunner.forward"},
    "resilience/engine.py": {
        "EpochLMRunner.make_prefill_fn": "EpochLMRunner.prefill",
        "EpochLMRunner.make_epoch_fn": "EpochLMRunner.epoch"},
}

# module -> {reference name: why the port has no counterpart}
NOT_CARRIED = {
    "kernels/bitgemm.py": {"TM": TILING, "TN": TILING, "TKW": TILING},
    "kernels/bitgemm_mxu.py": {"TM": TILING, "TN": TILING, "TK": TILING},
    "kernels/fused_qgemm.py": {"TM": TILING, "TN": TILING, "TK": TILING},
    "kernels/quantpack.py": {
        "TM": TILING, "TK": TILING,
        "LANE": "the TPU's 32-lane packing width; the port packs 32-bit "
                "words in quantpack.cu"},
    "kernels/conv_implicit.py": {
        "TCOUT": TILING, "TOH": TILING,
        "implicit_xla_exact": "the f32 mantissa bound of the reference's "
                              "off-TPU float conv; the port's plain "
                              "version accumulates exactly in float64"},
    "kernels/ops.py": {
        "PAGED_VMEM_BUDGET": "the paged Pallas kernel's VMEM budget; the "
                             "port's bound is attn_flash.paged_smem_bytes",
        "PALLAS_ENGINES": "splits the engines that need Pallas from the "
                          "XLA ones; every port engine is in ops.ENGINES",
        "PORTABLE_ENGINES": "the XLA half of that split",
        "ConvShape.padded_image_elems": "the implicit Pallas kernel's VMEM "
                                        "image; the port's counterpart is "
                                        "conv_implicit.smem_layout"},
    "api/targets.py": {
        "CpuTarget": "an XLA backend's cost table; the port's one compute "
                     "target is cuda",
        "TpuTarget": "an XLA backend's cost table (the port's cuda target "
                     "takes its engine table)",
        "CPU": "the registered CpuTarget",
        "TPU": "the registered TpuTarget",
        "CpuTarget.select_engine": "CpuTarget's dispatch",
        "TpuTarget.select_engine": "TpuTarget's dispatch",
        "HardwareTarget.cost": "the abstract base's method; ComputeTarget "
                               "and PIMTarget each define cost"},
    "models/layers.py": {
        "AttnCache": "unused in the reference",
        "norm_init": "inlined: the port's initializers build the ones "
                     "vector where they use it"},
    "distributed/sharding.py": {
        "mesh_context": "a JAX mesh context; the port passes a DeviceMesh "
                        "wherever it uses one"},
    "launch/serve.py": {
        "widen_cache": "a deprecated alias of grow_cache"},
    "launch/steps.py": {"S": "jax.ShapeDtypeStruct; the port's dry run "
                             "uses meta tensors"},
}

# reference modules with no port module at all
NOT_CARRIED_MODULES = {
    "pim/accelsim.py": "a deprecated re-export shim over api/reports and "
                       "api/targets",
}

REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def inventory(path: pathlib.Path, imports: bool = True):
    """(names, methods, flags): public top-level names (defined, and with
    ``imports`` imported; a package's ``__init__`` always counts the names
    it imports from its own package, its re-exports), ``Class.method`` of
    public classes, ``--flags``."""
    tree = ast.parse(path.read_text())
    init = path.name == "__init__.py"
    names, methods, flags = set(), set(), set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
            if isinstance(node, ast.ClassDef) and \
                    not node.name.startswith("_"):
                methods.update(
                    f"{node.name}.{m.name}" for m in node.body
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not m.name.startswith("_"))
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                elts = t.elts if isinstance(t, ast.Tuple) else [t]
                names.update(e.id for e in elts if isinstance(e, ast.Name))
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)) and (
                imports or (init and isinstance(node, ast.ImportFrom)
                            and (node.level or node.module.startswith(
                                "repro")))):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "add_argument":
            flags.update(a.value for a in node.args
                         if isinstance(a, ast.Constant)
                         and isinstance(a.value, str)
                         and a.value.startswith("--"))
    return ({n for n in names if not n.startswith("_")}, methods, flags)


def _ref_items(rel: str) -> set:
    names, methods, flags = inventory(REF / rel, imports=False)
    return names | methods | flags


def _port_items(rel: str) -> set:
    names, methods, flags = inventory(PORT / rel)
    return names | methods | flags


def _port_has(rel: str, name: str) -> bool:
    if ":" in name:
        rel, name = name.split(":")
    return (PORT / rel).exists() and name in _port_items(rel)


def test_the_reference_tree_is_walked():
    assert len(REF_MODULES) > 60
    assert "core/plan.py" in REF_MODULES and "launch/serve.py" in REF_MODULES


@pytest.mark.parametrize("rel", REF_MODULES)
def test_every_reference_name_and_flag_is_carried(rel):
    """The port's module at the same path holds each public name, method
    and flag of the reference's, or the tables account for it."""
    if rel in NOT_CARRIED_MODULES:
        assert not (PORT / rel).exists(), f"{rel} is ported: drop its entry"
        return
    assert (PORT / rel).exists(), f"no port module for {rel}"
    missing = _ref_items(rel) - _port_items(rel)
    renamed = RENAMED.get(rel, {})
    skipped = NOT_CARRIED.get(rel, {})
    unaccounted = sorted(n for n in missing
                         if n not in renamed and n not in skipped)
    assert not unaccounted, (
        f"{rel}: the port lacks {unaccounted} and the tables give no "
        f"rename or reason")
    for ref_name, port_name in renamed.items():
        assert _port_has(rel, port_name), (rel, ref_name, port_name)


@pytest.mark.parametrize("table", ["renamed", "not_carried"])
def test_tables_name_only_what_the_reference_has_and_the_port_lacks(table):
    entries = RENAMED if table == "renamed" else NOT_CARRIED
    for rel, names in entries.items():
        ref, port = _ref_items(rel), _port_items(rel)
        for name in names:
            assert name in ref, f"{rel}: the reference has no {name}"
            assert name not in port, (f"{rel}: the port has {name}; drop "
                                      f"its {table} entry")
    for rel, reason in NOT_CARRIED_MODULES.items():
        assert (REF / rel).exists() and reason


def test_reasons_are_given():
    for names in NOT_CARRIED.values():
        for name, reason in names.items():
            assert len(reason) > 10, name


def test_the_newly_ported_names_are_found():
    """The names the last slice ported, seen by the walk: the legacy
    served entry point's plan, the spec walk, the storage and complexity
    models, and the flags."""
    for rel, name in [("core/plan.py", "cnn_serve_layers"),
                      ("pim/mapper.py", "compare_designs"),
                      ("pim/mapper.py", "model_work"),
                      ("models/cnn.py", "count_macs"),
                      ("core/quant.py", "model_storage_bits"),
                      ("core/quant.py", "QuantConfig.inference_complexity"),
                      ("core/prequant.py", "serve_weight_bytes"),
                      ("launch/engine.py", "ContinuousLMEngine.warm"),
                      ("launch/engine.py", "CNNRunner.plan_fingerprint"),
                      ("launch/serve.py", "--prequant"),
                      ("launch/train.py", "--multi-pod")]:
        assert name in _ref_items(rel) and name in _port_items(rel), (
            rel, name)
