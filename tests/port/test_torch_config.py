"""The port's ``CfgNode`` against the JAX package's: the same operations on
both give equal trees (compared as plain dicts, with value types), the same
frozen state and the same exception types and messages. The YAML cases run
where ``yaml`` imports; the port's module itself imports without it.
Everything is exact."""

import importlib.util
import sys

import pytest

pytest.importorskip("jax")

from gradslam_torch.config import cfgnode as torch_cfgnode  # noqa: E402
from gradslam_tpu.config import cfgnode as jax_cfgnode  # noqa: E402


def base(mod, **kw):
    return mod.CfgNode({
        "SLAM": {"odom": "gradicp", "dsratio": 4, "pyramid": [[8, 6], [4, 4]]},
        "DATA": {"height": 480, "width": 640, "sequences": ["a", "b"], "crop": (1, 2),
                 "scale": 0.5, "normalize": False, "name": None},
    }, **kw)


def plain(node):
    """A tree as nested dicts of ``(type name, value)`` leaves."""
    if isinstance(node, dict):
        return {k: plain(v) for k, v in node.items()}
    return (type(node).__name__, node)


def outcome(mod, fn):
    """``fn(mod)``'s tree, or its exception's type and message."""
    try:
        cfg = fn(mod)
    except Exception as e:  # the exception itself is the result compared
        return ("raised", type(e).__name__, str(e))
    return ("ok", plain(cfg), cfg.is_frozen() if isinstance(cfg, mod.CfgNode) else None)


def merged_other(other):
    def fn(mod):
        cfg = base(mod)
        cfg.merge_from_other_cfg(mod.CfgNode(other))
        return cfg
    return fn


def merged_list(pairs):
    def fn(mod):
        cfg = base(mod)
        cfg.merge_from_list(pairs)
        return cfg
    return fn


def _frozen_set(mod):
    cfg = base(mod)
    cfg.freeze()
    cfg.SLAM.odom = "icp"
    return cfg


def _frozen_then_defrosted(mod):
    cfg = base(mod)
    cfg.freeze()
    cfg.defrost()
    cfg.SLAM.odom = "icp"
    return cfg


def _registered(mod):
    cfg = base(mod)
    cfg.register_deprecated_key("OLD.KEY")
    cfg.merge_from_list(["OLD.KEY", "1", "SLAM.dsratio", "2"])
    cfg.register_renamed_key("OLD.NAME", "SLAM.odom", "use SLAM.odom")
    cfg.merge_from_list(["OLD.NAME", "icp"])
    return cfg


def _new_allowed(mod):
    cfg = mod.CfgNode({"A": 1}, new_allowed=True)
    cfg.merge_from_other_cfg(mod.CfgNode({"B": {"C": 2}}))
    return cfg


def _clone(mod):
    cfg = base(mod)
    c2 = cfg.clone()
    c2.SLAM.odom = "icp"
    cfg.DATA.extra = (3, 4)
    return mod.CfgNode({"orig": cfg, "clone": c2})


def _bad_type(mod):
    return mod.CfgNode({"A": {1, 2}})


def _internal(mod):
    cfg = base(mod)
    cfg.__immutable__ = True
    return cfg


CASES = {
    "construct": lambda mod: base(mod),
    "frozen": lambda mod: (lambda c: (c.freeze(), c)[1])(base(mod)),
    "frozen_set": _frozen_set,
    "defrost": _frozen_then_defrosted,
    "merge_other": merged_other({"SLAM": {"odom": "gt"}, "DATA": {"sequences": ("c",)}}),
    "merge_other_tuple_to_list": merged_other({"DATA": {"crop": [5, 6]}}),
    "merge_other_missing": merged_other({"BOGUS": 1}),
    "merge_other_type_mismatch": merged_other({"DATA": {"height": "tall"}}),
    "merge_other_none": merged_other({"DATA": {"name": "x"}}),
    "merge_list": merged_list(["SLAM.dsratio", "8", "DATA.height", "240",
                               "DATA.crop", "[7, 8]", "DATA.scale", "0.25",
                               "SLAM.odom", "icp", "DATA.sequences", "('x',)"]),
    "merge_list_odd": merged_list(["SLAM.dsratio"]),
    "merge_list_missing": merged_list(["SLAM.nothing", "1"]),
    "merge_list_bool_to_int": merged_list(["DATA.normalize", "1"]),
    "registered": _registered,
    "new_allowed": _new_allowed,
    "clone": _clone,
    "bad_type": _bad_type,
    "internal_state": _internal,
}


@pytest.mark.parametrize("case", list(CASES))
def test_cfgnode_equals_jax(case):
    assert outcome(torch_cfgnode, CASES[case]) == outcome(jax_cfgnode, CASES[case])


def test_str_repr_and_attribute_errors_equal_jax():
    j, t = base(jax_cfgnode), base(torch_cfgnode)
    assert str(t) == str(j)
    assert repr(t) == repr(j)
    for cfg in (j, t):
        with pytest.raises(AttributeError):
            cfg.NOPE


def _yaml_cases(mod, tmp_path):
    yaml_text = "SLAM:\n  odom: gt\n  pyramid: [[2, 3]]\nDATA:\n  crop: [9, 9]\n"
    out = {}
    cfg = base(mod)
    out["dump"] = cfg.dump()
    out["dump_kwargs"] = cfg.dump(default_flow_style=True)
    out["load_str"] = plain(mod.load_cfg("SLAM:\n  odom: icp\n"))
    f = tmp_path / "cfg.yaml"
    f.write_text(yaml_text)
    cfg = base(mod)
    cfg.merge_from_file(str(f))
    out["merge_file"] = plain(cfg)
    with open(f) as fh:
        out["load_stream"] = plain(mod.load_cfg(fh))
    py = tmp_path / "mycfg.py"
    py.write_text("cfg = {'SLAM': {'odom': 'icp', 'dsratio': 2}}\n")
    with open(py) as fh:
        out["load_py"] = plain(mod.load_cfg(fh))
    bad = tmp_path / "bad.py"
    bad.write_text("not_cfg = 1\n")
    with open(bad) as fh:
        out["load_py_bad"] = outcome(mod, lambda m: m.load_cfg(fh))
    out["load_bad_arg"] = outcome(mod, lambda m: m.load_cfg(3))
    return out


def test_yaml_dump_and_load_equal_jax(tmp_path):
    yaml = pytest.importorskip("yaml")
    got = _yaml_cases(torch_cfgnode, tmp_path)
    assert got == _yaml_cases(jax_cfgnode, tmp_path)
    assert yaml.safe_load(got["dump"])["SLAM"]["odom"] == "gradicp"


def test_the_module_imports_without_yaml(monkeypatch):
    """With ``yaml`` unimportable a fresh copy of the module (loaded under
    another name, so the package's own stays as it is) imports and its
    trees work; only the YAML functions raise ``ImportError``."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    spec = importlib.util.spec_from_file_location("cfgnode_without_yaml", torch_cfgnode.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = base(mod)
    cfg.merge_from_list(["SLAM.dsratio", "2"])
    assert cfg.SLAM.dsratio == 2
    with pytest.raises(ImportError):
        cfg.dump()
    with pytest.raises(ImportError):
        mod.load_cfg("A: 1\n")
