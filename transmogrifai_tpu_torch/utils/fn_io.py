"""Function (de)serialization for lambda-carrying stages — the port of
``transmogrifai_tpu/utils/fn_io.py``, in the same format.

The reference persists ``FeatureBuilder.extract``/DSL lambdas as compiled
JVM classes reinstantiated reflectively; Python has no such luxury, so:

* module-level functions round-trip by qualified name (robust path);
* lambdas/local functions round-trip by marshaled code object + closure cell
  values (works for the closure-free or simple-valued closures the DSL
  produces; anything else raises at save time, not load time).

Loading marshaled code executes it — the same trust model as unpickling a
model file. Only load models you trust. A named function of the JAX
package (``transmogrifai_tpu.<m>``) is read as this package's
(``transmogrifai_tpu_torch.<m>``): the port never imports the JAX package.
"""
from __future__ import annotations

import base64
import importlib
import marshal
import types
from typing import Any, Callable, Dict

__all__ = ["encode_fn", "decode_fn", "FunctionSerializationError"]


class FunctionSerializationError(ValueError):
    pass


#: module-level names available to deserialized lambdas (decode_fn globals)
_LAMBDA_MODULES = ("math", "re", "json", "datetime")


def _check_names(code, allowed: set, qualname: str) -> None:
    """Save-time check: every global the code loads must exist in the
    decode-side globals, so failures surface at save, not at scoring.

    Uses dis to look only at LOAD_GLOBAL targets — co_names also holds
    attribute names, which are not globals."""
    import builtins
    import dis
    for ins in dis.get_instructions(code):
        if ins.opname == "LOAD_GLOBAL":
            name = ins.argval
            if name in allowed or hasattr(builtins, name):
                continue
            raise FunctionSerializationError(
                f"Lambda {qualname or '<lambda>'} references global "
                f"{name!r}, which won't exist after loading (available: np, "
                f"{', '.join(_LAMBDA_MODULES)}, builtins). Use a "
                "module-level function instead.")
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            _check_names(const, allowed, qualname)


def encode_fn(fn: Callable) -> Dict[str, Any]:
    import numpy as np
    if isinstance(fn, np.ufunc):
        return {"kind": "named", "module": "numpy", "qualname": fn.__name__}
    if not hasattr(fn, "__code__"):
        raise FunctionSerializationError(
            f"Cannot serialize callable {fn!r} (no __code__); use a "
            "module-level function")
    mod = getattr(fn, "__module__", None)
    qualname = getattr(fn, "__qualname__", "")
    if mod and qualname and "<lambda>" not in qualname and "<locals>" not in qualname:
        return {"kind": "named", "module": mod, "qualname": qualname}
    closure = ()
    if fn.__closure__:
        try:
            closure = tuple(c.cell_contents for c in fn.__closure__)
            marshal.dumps(closure)
        except (ValueError, TypeError) as e:
            raise FunctionSerializationError(
                f"Cannot serialize closure of {qualname or fn}: {e}. "
                "Use a module-level function instead.") from e
    allowed = {"np", *_LAMBDA_MODULES,
               *(fn.__code__.co_varnames), *(fn.__code__.co_freevars)}
    _check_names(fn.__code__, allowed, qualname)
    return {
        "kind": "code",
        "code": base64.b64encode(marshal.dumps(fn.__code__)).decode("ascii"),
        "defaults": list(fn.__defaults__ or ()),
        "closure": list(closure),
        "name": fn.__name__,
    }


_PKG = __name__.partition(".")[0]
_REF_PKG = "transmogrifai_tpu"


def decode_fn(spec: Dict[str, Any]) -> Callable:
    if spec["kind"] == "named":
        module = spec["module"]
        if module == _REF_PKG or module.startswith(_REF_PKG + "."):
            module = _PKG + module[len(_REF_PKG):]
        obj: Any = importlib.import_module(module)
        for part in spec["qualname"].split("."):
            obj = getattr(obj, part)
        return obj
    code = marshal.loads(base64.b64decode(spec["code"]))
    import builtins
    import numpy as np
    globs = {"__builtins__": builtins, "np": np}
    for m in _LAMBDA_MODULES:
        globs[m] = importlib.import_module(m)
    closure = tuple(types.CellType(v) for v in spec["closure"])
    fn = types.FunctionType(code, globs, spec["name"],
                            tuple(spec["defaults"]), closure or None)
    return fn
