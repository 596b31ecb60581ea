r"""YACS-style configuration tree of the PyTorch port.

Counterpart of ``gradslam_tpu/config/cfgnode.py`` (``CfgNode`` :38-240,
``_merge_a_into_b``, the type coercion and ``load_cfg``; reference
``gradslam/config/cfgnode.py:37``), the same code: the port keeps its own
copy because importing ``gradslam_tpu`` imports JAX. A dict subclass with
attribute access, freeze/defrost immutability, deep merging from YAML files,
other configs and dotted key lists, deprecated and renamed key registries,
YAML dump, and type coercion (list <-> tuple only). ``yaml`` is imported
only by the functions that parse or dump YAML, so the package imports on a
machine without it.
"""

from __future__ import annotations

import copy
import importlib.util
import io
from ast import literal_eval
from typing import Any, Dict, List, Optional

__all__ = ["CfgNode", "load_cfg"]

_VALID_TYPES = {tuple, list, str, int, float, bool, type(None)}


def _assert_with_logging(cond: bool, msg: str):
    if not cond:
        raise AssertionError(msg)


def _valid_type(value, allow_cfg_node: bool = False) -> bool:
    return (type(value) in _VALID_TYPES) or (
        allow_cfg_node and isinstance(value, CfgNode)
    )


class CfgNode(dict):
    IMMUTABLE = "__immutable__"
    DEPRECATED_KEYS = "__deprecated_keys__"
    RENAMED_KEYS = "__renamed_keys__"
    NEW_ALLOWED = "__new_allowed__"

    def __init__(
        self,
        init_dict: Optional[Dict] = None,
        key_list: Optional[List[str]] = None,
        new_allowed: bool = False,
    ):
        init_dict = {} if init_dict is None else init_dict
        key_list = [] if key_list is None else key_list
        init_dict = self._create_config_tree_from_dict(init_dict, key_list)
        super().__init__(init_dict)
        self.__dict__[CfgNode.IMMUTABLE] = False
        self.__dict__[CfgNode.DEPRECATED_KEYS] = set()
        self.__dict__[CfgNode.RENAMED_KEYS] = {}
        self.__dict__[CfgNode.NEW_ALLOWED] = new_allowed

    @classmethod
    def _create_config_tree_from_dict(cls, init_dict: Dict, key_list: List[str]):
        d = copy.deepcopy(init_dict)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = cls(v, key_list=key_list + [str(k)])
            else:
                _assert_with_logging(
                    _valid_type(v, allow_cfg_node=False),
                    f"Key {'.'.join(key_list + [str(k)])} with value {type(v)} "
                    "is not a valid type; valid types: {}".format(_VALID_TYPES),
                )
        return d

    # -- attribute access ------------------------------------------------ #
    def __getattr__(self, name: str):
        if name in self:
            return self[name]
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any):
        if self.is_frozen():
            raise AttributeError(
                f"Attempted to set {name} to {value}, but CfgNode is immutable"
            )
        _assert_with_logging(
            name not in self.__dict__,
            f"Invalid attempt to modify internal CfgNode state: {name}",
        )
        _assert_with_logging(
            _valid_type(value, allow_cfg_node=True),
            f"Invalid type {type(value)} for key {name}; valid types = {_VALID_TYPES}",
        )
        self[name] = value

    def __str__(self):
        def _indent(s, num_spaces):
            lines = s.split("\n")
            if len(lines) == 1:
                return s
            first = lines.pop(0)
            lines = [(num_spaces * " ") + line for line in lines]
            return first + "\n" + "\n".join(lines)

        r = ""
        for k, v in sorted(self.items()):
            sep = "\n" if isinstance(v, CfgNode) else " "
            attr_str = f"{str(k)}:{sep}{str(v)}"
            r += _indent(attr_str, 2) + "\n"
        return r.rstrip("\n")

    def __repr__(self):
        return f"{self.__class__.__name__}({super().__repr__()})"

    # -- (im)mutability ---------------------------------------------------#
    def freeze(self):
        """Make this node and all children immutable (reference cfgnode.py:238)."""
        self._immutable(True)

    def defrost(self):
        """Make this node and all children mutable again (reference cfgnode.py:242)."""
        self._immutable(False)

    def is_frozen(self) -> bool:
        """Whether the node is currently immutable."""
        return self.__dict__[CfgNode.IMMUTABLE]

    def _immutable(self, is_immutable: bool):
        self.__dict__[CfgNode.IMMUTABLE] = is_immutable
        for v in self.__dict__.values():
            if isinstance(v, CfgNode):
                v._immutable(is_immutable)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._immutable(is_immutable)

    def clone(self) -> "CfgNode":
        """Deep copy of the whole config tree."""
        return copy.deepcopy(self)

    # -- serialization --------------------------------------------------- #
    def dump(self, **kwargs) -> str:
        """Serialize to a YAML string (kwargs forwarded to yaml.safe_dump)."""
        import yaml

        def convert(node):
            if not isinstance(node, CfgNode):
                _assert_with_logging(
                    _valid_type(node),
                    f"Key {node} with value {type(node)} is not a valid type",
                )
                return node
            return {k: convert(v) for k, v in node.items()}

        return yaml.safe_dump(convert(self), **kwargs)

    # -- merging ----------------------------------------------------------#
    def merge_from_file(self, cfg_filename: str):
        """Deep-merge the YAML config at ``cfg_filename`` into this node."""
        with open(cfg_filename) as f:
            cfg = load_cfg(f)
        self.merge_from_other_cfg(cfg)

    def merge_from_other_cfg(self, cfg_other: "CfgNode"):
        """Deep-merge another CfgNode into this one."""
        _merge_a_into_b(cfg_other, self, self, [])

    def merge_from_list(self, cfg_list: List):
        """Merge ``[key1, value1, key2, value2, ...]`` dotted-key overrides
        (the CLI override form)."""
        _assert_with_logging(
            len(cfg_list) % 2 == 0,
            f"Override list has odd length: {cfg_list}; it must be a list of pairs",
        )
        for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
            if self.key_is_deprecated(full_key):
                continue
            if self.key_is_renamed(full_key):
                self.raise_key_rename_error(full_key)
            key_list = full_key.split(".")
            d = self
            for subkey in key_list[:-1]:
                _assert_with_logging(subkey in d, f"Non-existent key: {full_key}")
                d = d[subkey]
            subkey = key_list[-1]
            _assert_with_logging(subkey in d, f"Non-existent key: {full_key}")
            value = self._decode_cfg_value(v)
            value = _check_and_coerce_cfg_value_type(value, d[subkey], subkey, full_key)
            d[subkey] = value

    # -- deprecated / renamed keys ---------------------------------------- #
    def register_deprecated_key(self, key: str):
        """Mark a dotted key as deprecated: merging it warns and skips it."""
        _assert_with_logging(
            key not in self.__dict__[CfgNode.DEPRECATED_KEYS],
            f"key {key} is already registered as a deprecated key",
        )
        self.__dict__[CfgNode.DEPRECATED_KEYS].add(key)

    def register_renamed_key(self, old_name: str, new_name: str, message=None):
        """Mark a dotted key as renamed: merging the old key raises with a
        pointer to ``new_name`` (plus optional ``message``)."""
        _assert_with_logging(
            old_name not in self.__dict__[CfgNode.RENAMED_KEYS],
            f"key {old_name} is already registered as a renamed cfg key",
        )
        value = (new_name, message) if message else new_name
        self.__dict__[CfgNode.RENAMED_KEYS][old_name] = value

    def key_is_deprecated(self, full_key: str) -> bool:
        """Whether ``full_key`` is registered as deprecated."""
        return full_key in self.__dict__[CfgNode.DEPRECATED_KEYS]

    def key_is_renamed(self, full_key: str) -> bool:
        """Whether ``full_key`` is registered as renamed."""
        return full_key in self.__dict__[CfgNode.RENAMED_KEYS]

    def raise_key_rename_error(self, full_key: str):
        """Raise the KeyError explaining where ``full_key`` moved."""
        new_key = self.__dict__[CfgNode.RENAMED_KEYS][full_key]
        if isinstance(new_key, tuple):
            msg = " Note: " + new_key[1]
            new_key = new_key[0]
        else:
            msg = ""
        raise KeyError(
            f"Key {full_key} was renamed to {new_key}; please update your config.{msg}"
        )

    def is_new_allowed(self) -> bool:
        """Whether merging may introduce keys not present in this node."""
        return self.__dict__[CfgNode.NEW_ALLOWED]

    # -- value decoding -----------------------------------------------------#
    @classmethod
    def _decode_cfg_value(cls, value):
        if isinstance(value, dict):
            return cls(value)
        if not isinstance(value, str):
            return value
        try:
            value = literal_eval(value)
        except (ValueError, SyntaxError):
            pass
        return value


def _merge_a_into_b(a: CfgNode, b: CfgNode, root: CfgNode, key_list: List[str]):
    _assert_with_logging(
        isinstance(a, CfgNode), f"`a` (cur type {type(a)}) must be an instance of CfgNode"
    )
    _assert_with_logging(
        isinstance(b, CfgNode), f"`b` (cur type {type(b)}) must be an instance of CfgNode"
    )
    for k, v_ in a.items():
        full_key = ".".join(key_list + [str(k)])
        v = copy.deepcopy(v_)
        v = b._decode_cfg_value(v)
        if k in b:
            v = _check_and_coerce_cfg_value_type(v, b[k], k, full_key)
            if isinstance(v, CfgNode):
                try:
                    _merge_a_into_b(v, b[k], root, key_list + [str(k)])
                except BaseException:
                    raise
            else:
                b[k] = v
        elif b.is_new_allowed():
            b[k] = v
        else:
            if root.key_is_deprecated(full_key):
                continue
            if root.key_is_renamed(full_key):
                root.raise_key_rename_error(full_key)
            raise KeyError(f"Non-existent config key: {full_key}")


def _check_and_coerce_cfg_value_type(replacement, original, key, full_key):
    original_type = type(original)
    replacement_type = type(replacement)
    if replacement_type == original_type:
        return replacement
    if (
        isinstance(replacement, dict)
        and isinstance(original, CfgNode)
        or replacement_type == CfgNode
        and original_type == dict
    ):
        return replacement

    def conditional_cast(from_type, to_type):
        if replacement_type == from_type and original_type == to_type:
            return True, to_type(replacement)
        return False, None

    casts = [(tuple, list), (list, tuple)]
    for from_type, to_type in casts:
        converted, converted_value = conditional_cast(from_type, to_type)
        if converted:
            return converted_value
    raise ValueError(
        f"Type mismatch ({original_type} vs. {replacement_type}) with values "
        f"({original} vs. {replacement}) for config key: {full_key}"
    )


def load_cfg(cfg_file_obj_or_str) -> CfgNode:
    r"""Load a CfgNode from a YAML string/stream, a ``.yaml`` file object, or
    a python module path exporting ``cfg`` (reference cfgnode.py:324-425)."""
    _assert_with_logging(
        isinstance(cfg_file_obj_or_str, (io.IOBase, str)),
        f"Expected first argument to be of type str or file object, "
        f"but it was {type(cfg_file_obj_or_str)}",
    )
    if isinstance(cfg_file_obj_or_str, str):
        return _load_cfg_from_yaml_str(cfg_file_obj_or_str)
    if cfg_file_obj_or_str.name.endswith(".py"):
        return _load_cfg_py_source(cfg_file_obj_or_str.name)
    return _load_cfg_from_yaml_str(cfg_file_obj_or_str.read())


def _load_cfg_from_yaml_str(str_obj: str) -> CfgNode:
    import yaml

    cfg_as_dict = yaml.safe_load(str_obj)
    return CfgNode(cfg_as_dict)


def _load_cfg_py_source(filename: str) -> CfgNode:
    module = _load_module_from_file("yacs.config.override", filename)
    _assert_with_logging(
        hasattr(module, "cfg"),
        f"Python module from file {filename} must export a 'cfg' attribute",
    )
    VALID_ATTR_TYPES = {dict, CfgNode}
    _assert_with_logging(
        type(module.cfg) in VALID_ATTR_TYPES,
        f"Imported module 'cfg' attribute must be in {VALID_ATTR_TYPES} "
        f"but is {type(module.cfg)} instead",
    )
    return CfgNode(module.cfg)


def _load_module_from_file(name: str, filename: str):
    spec = importlib.util.spec_from_file_location(name, filename)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
