"""Config dump CLI of the port (its own copy of ``basedet_tpu/tools/dump_cfg.py``):
class-config → flat, editable python source.

    python -m basedet_tpu_torch.tools.dump_cfg -f <config.py> [-o dumped_config.py] [-p DIR]

Capability analogue of the reference's AST/inspect converter
(the MegEngine basedet ``tools/dump_cfg.py:22-309``): nested ``dict(...)``
style source (not a pprint blob), ``float('inf')`` literals, user-defined
methods of the Cfg class (build_model overrides etc.) carried over verbatim
via inspect.getsource, and a round-trip diff check that re-imports the
dumped file and asserts it reconstructs the identical config.
"""
from __future__ import annotations

import inspect
import os
import pprint
import types

from basedet_tpu_torch.tools.misc import default_parser, import_config
from basedet_tpu_torch.utils.logger import logger

_INDENT = " " * 4


def _contains_inf(v) -> bool:
    if isinstance(v, (tuple, list)):
        return any(x == float("inf") or _contains_inf(x) for x in v)
    return False


def _value_source(v, depth: int) -> str:
    if isinstance(v, dict):
        return _dict_source(v, depth)
    if isinstance(v, float) and v == float("inf"):
        return "float('inf')"
    if _contains_inf(v):
        return pprint.pformat(v).replace("inf", "float('inf')")
    if isinstance(v, types.FunctionType):
        # lambdas/functions stored in configs: keep their name; their
        # definition is carried over with the class methods
        return getattr(v, "__name__", repr(v))
    return pprint.pformat(v, width=80)


def _dict_source(d: dict, depth: int = 1) -> str:
    """Nested ``dict(key=value, ...)`` source (reference pretty_dict_code,
    dump_cfg.py:79-97)."""
    lines = ["dict("]
    pad = _INDENT * depth
    for k, v in d.items():
        if not k.isidentifier():
            # non-identifier key: splice in as a dict literal entry
            lines.append(f"{pad}**{{{k!r}: {_value_source(v, depth + 1)}}},")
            continue
        lines.append(f"{pad}{k}={_value_source(v, depth + 1)},")
    lines.append(_INDENT * (depth - 1) + ")")
    return os.linesep.join(lines)


def _extra_methods_source(cfg) -> str:
    """Source of methods defined on the user's Cfg class itself (overrides
    like build_model), carried over verbatim (reference generate_obj_function
    semantics)."""
    cls = type(cfg)
    chunks = []
    for name, member in vars(cls).items():
        if name in ("__init__", "__module__", "__doc__", "__qualname__",
                    "__dict__", "__weakref__"):
            continue
        func = None
        if isinstance(member, (types.FunctionType, classmethod, staticmethod,
                               property)):
            func = member
        if func is None:
            continue
        try:
            chunks.append(inspect.getsource(
                func.fget if isinstance(func, property) else
                func.__func__ if isinstance(func, (classmethod, staticmethod))
                else func
            ))
        except (OSError, TypeError):
            logger.warning(f"cannot recover source of {cls.__name__}.{name}")
    return os.linesep.join(chunks)


def dump_config_source(cfg) -> str:
    flat = _dict_source(cfg.to_dict(), depth=2)
    methods = _extra_methods_source(cfg)
    body = f'''"""Auto-dumped flat config (basedet_tpu_torch dump_cfg)."""
from basedet_tpu_torch.configs import DetectionConfig


class Cfg(DetectionConfig):
    def __init__(self):
        super().__init__()
        self.merge({flat})
'''
    if methods.strip():
        body += os.linesep + methods
    return body


def check_round_trip(cfg, path: str) -> None:
    """Re-import the dumped file and assert it rebuilds the same config
    (reference check_cfg_diff, dump_cfg.py:160-168)."""
    new_cfg = import_config(path)
    d1 = cfg.diff(new_cfg)
    d2 = new_cfg.diff(cfg)
    bad = {
        k: v for k, v in {**d1.to_dict(), **d2.to_dict()}.items()
        if not isinstance(v, types.FunctionType)
    }
    assert not bad, f"dumped config does not round-trip: {bad}"
    logger.info("round-trip check passed")


def main(args=None):
    parser = default_parser("basedet_tpu_torch dump_cfg")
    parser.add_argument("-o", "--output", type=str, default="dumped_config.py")
    parser.add_argument(
        "-p", "--path", type=str, default=None,
        help="output dir (default: alongside the input config)",
    )
    args = parser.parse_args(args)
    cfg = import_config(args.file)
    out = args.output
    if args.path:
        out = os.path.join(args.path, os.path.basename(args.output))
    source = dump_config_source(cfg)
    with open(out, "w") as f:
        f.write(source)
    check_round_trip(cfg, out)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
