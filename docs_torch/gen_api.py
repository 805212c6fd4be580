"""Generate ``docs_torch/api/*.md``, the API reference of ``stainx_tpu_torch``.

The port's counterpart of ``docs/gen_api.py``: the pages are rendered from
the live docstrings and signatures with :mod:`inspect` and committed, and
``tests/test_torch_docs_api.py`` regenerates them in memory and fails when
a committed page is missing, stale or an orphan. Regenerate with
``python docs_torch/gen_api.py``.

It imports the port only (never JAX or ``stainx_tpu``), and importing the
port builds no kernel. A class page documents the members the port's own
classes define, never those a class inherits from ``torch`` (their
signatures and docstrings change between torch versions), and no page
renders an address or a path of the machine, so the pages come out the
same wherever the generator runs.
"""

from __future__ import annotations

import importlib
import inspect
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

HEADER = (
    "<!-- GENERATED by docs_torch/gen_api.py — edit docstrings, not this file; "
    "regenerate with `python docs_torch/gen_api.py`. -->\n\n"
)

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "api")
PACKAGE = "stainx_tpu_torch"

# Methods shown first for every normalizer class, in contract order.
NORMALIZER_MEMBERS = [
    "fit",
    "transform",
    "fit_transform",
    "to_device",
    "state",
    "load_state",
    "save_state",
    "load_state_file",
]
OPS_MODULES = ("color", "macenko", "reinhard", "histogram_matching", "percentile", "eigh3")
KERNEL_MODULES = ("macenko_fused", "macenko_stream", "selection", "selection_stream",
                  "reinhard_fused", "histogram")
# A wrapper's plain version where its name is not the wrapper's + "_plain".
PLAIN_OF = {"hm_reference": None, "hm_transfer": "hm_transfer_plain",
            "reinhard_mean_std": None, "reinhard_transfer": None}


class _Text(str):
    """An annotation kept as the source wrote it, rendered without quotes."""

    def __repr__(self) -> str:
        quoted = len(self) > 1 and self[0] == self[-1] and self[0] in "'\""
        return str(self)[1:-1] if quoted else str(self)


def _sig(obj) -> str:
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return "(...)"
    params = [p.replace(annotation=_Text(p.annotation)) if isinstance(p.annotation, str) else p
              for p in sig.parameters.values()]
    ret = sig.return_annotation
    return str(sig.replace(parameters=params,
                           return_annotation=_Text(ret) if isinstance(ret, str) else ret))


def _doc(obj) -> str:
    """``obj``'s own docstring: never one inherited from a base class (an
    ``nn.Module`` method's would change with torch)."""
    doc = obj.__doc__ if isinstance(obj.__doc__, str) else None
    return inspect.cleandoc(doc) if doc else "*(no docstring)*"


def _own_members(cls) -> dict:
    """Public members defined by the port's classes in ``cls``'s MRO, the
    nearest definition of each name; nothing of ``torch`` or ``object``."""
    members: dict = {}
    for base in cls.__mro__:
        if not base.__module__.startswith(PACKAGE):
            continue
        for name, member in vars(base).items():
            if name.startswith("_") or name in members:
                continue
            if isinstance(member, (staticmethod, classmethod)):
                member = member.__func__
            if inspect.isfunction(member) or isinstance(member, property):
                members[name] = member
    return members


def _render_callable(name: str, obj, level: int = 3) -> str:
    head = "#" * level
    if isinstance(obj, property):
        return f"{head} `{name}` *(property)*\n\n{_doc(obj.fget)}\n"
    return f"{head} `{name}{_sig(obj)}`\n\n{_doc(obj)}\n"


def _render_class(cls, first: list[str] | None = None) -> str:
    out = [f"## `{cls.__module__}.{cls.__qualname__}{_sig(cls)}`\n", _doc(cls) + "\n"]
    members = _own_members(cls)
    order = [n for n in (first or []) if n in members]
    order += sorted(n for n in members if n not in order)
    out += [_render_callable(name, members[name]) for name in order]
    return "\n".join(out)


def _render_function(fn) -> str:
    return f"## `{fn.__module__}.{fn.__qualname__}{_sig(fn)}`\n\n{_doc(fn)}\n"


def _public_functions(mod) -> list[str]:
    return sorted(n for n, o in inspect.getmembers(mod, inspect.isfunction)
                  if not n.startswith("_") and o.__module__ == mod.__name__)


def _render_module(modname: str, names: list[str], title: str | None = None) -> str:
    mod = importlib.import_module(modname)
    out = [f"## `{title or modname}`\n", _doc(mod) + "\n"]
    for name in names:
        obj = getattr(mod, name)
        out.append(_render_class(obj) if inspect.isclass(obj) else _render_function(obj))
    return "\n".join(out)


def _render_kernel_module(modname: str) -> str:
    """A kernel module: its docstring, each wrapper (a function with a plain
    version ``<name>_plain``, or one of :data:`PLAIN_OF`) beside its plain
    version, then the other public functions."""
    mod = importlib.import_module(modname)
    names = _public_functions(mod)
    wrappers = [n for n in names if f"{n}_plain" in names and n not in PLAIN_OF]
    wrappers += [n for n in PLAIN_OF if n in names and n not in wrappers]
    shown = set()
    out = [f"## `{modname}`\n", _doc(mod) + "\n"]
    for name in wrappers:
        plain = PLAIN_OF.get(name, f"{name}_plain")
        out.append(f"### Kernel wrapper `{name}`\n")
        out.append(_render_callable(name, getattr(mod, name), level=4))
        if plain in names:
            out.append(f"#### Its plain version: `{plain}{_sig(getattr(mod, plain))}`\n\n"
                       f"{_doc(getattr(mod, plain))}\n")
            shown.add(plain)
        shown.add(name)
    rest = [n for n in names if n not in shown]
    if rest:
        out.append("### Helpers\n")
        out += [_render_callable(name, getattr(mod, name), level=4) for name in rest]
    return "\n".join(out)


def build_pages() -> dict[str, str]:
    """Return ``{filename: markdown}`` for every generated API page."""
    import stainx_tpu_torch.io as io_pkg
    import stainx_tpu_torch.parallel as parallel_pkg
    from stainx_tpu_torch import HistogramMatching, Macenko, Reinhard, StainNormalizerTransform
    from stainx_tpu_torch.base import StainNormalizerBase
    from stainx_tpu_torch.normalizers._template import NormalizerTemplate

    pages: dict[str, str] = {}
    pages["index.md"] = """# API reference of `stainx_tpu_torch`

The PyTorch / CUDA port of `stainx_tpu`, generated from the live docstrings
by `docs_torch/gen_api.py` (`tests/test_torch_docs_api.py` keeps these pages
from drifting). Every entry point runs on `cuda:0` unless the caller passes
`device="cpu"`, which runs the kernels' plain PyTorch versions.

| Page | Contents |
|---|---|
| [Macenko](macenko.md) | H&E stain-vector normalization |
| [Reinhard](reinhard.md) | LAB mean/std transfer |
| [HistogramMatching](histogram_matching.md) | Per-channel CDF matching |
| [Base classes](base.md) | `StainNormalizerBase`, `NormalizerTemplate`: the shared fit/transform/state surface |
| [Transform](transform.md) | `StainNormalizerTransform`, the `torch.nn.Module` for training pipelines |
| [Distributed](parallel.md) | `stainx_tpu_torch.parallel`: meshes, exact sharded fits, sharded transforms |
| [Ops](ops.md) | `stainx_tpu_torch.ops`: the pipelines, their routes and the percentile wrappers |
| [Kernels](kernels.md) | `stainx_tpu_torch.kernels`: each hand-written CUDA kernel's wrapper beside its plain version |
| [IO](io.md) | `stainx_tpu_torch.io`: native threaded tile ingestion with a page-locked copy |
| [Utilities](utils.md) | `get_device`, `ChannelFormatConverter`, `profiling`, `convert.state_from_jax` |

There is no backends page: the port has no `backend` option, since the
device decides the route (`stainx_tpu_torch/transforms.py`).
"""

    for cls, fname in ((Macenko, "macenko.md"), (Reinhard, "reinhard.md"),
                       (HistogramMatching, "histogram_matching.md")):
        pages[fname] = f"# {cls.__name__}\n\n" + _render_class(cls, NORMALIZER_MEMBERS)

    pages["base.md"] = (
        "# Base classes\n\nThe surface every normalizer shares. Use "
        "[`Macenko`](macenko.md), [`Reinhard`](reinhard.md) or "
        "[`HistogramMatching`](histogram_matching.md).\n\n"
        + _render_class(StainNormalizerBase, NORMALIZER_MEMBERS) + "\n"
        + _render_class(NormalizerTemplate, NORMALIZER_MEMBERS)
    )

    pages["transform.md"] = (
        "# StainNormalizerTransform\n\nOnly the members this class defines are shown; "
        "the rest is `torch.nn.Module`'s.\n\n" + _render_class(StainNormalizerTransform, ["forward"])
    )

    pages["parallel.md"] = "# Distributed\n\n" + _render_module(
        "stainx_tpu_torch.parallel", list(parallel_pkg.__all__))

    pages["ops.md"] = (
        "# Ops\n\nThe pipelines behind the normalizers, their size routes, and the "
        "building blocks they share. On a CUDA tensor each reaches the kernel wrappers "
        "of [Kernels](kernels.md); on a CPU tensor their plain versions.\n\n"
        + "\n".join(_render_module(f"stainx_tpu_torch.ops.{sub}", _public_functions(
            importlib.import_module(f"stainx_tpu_torch.ops.{sub}"))) for sub in OPS_MODULES)
    )

    kernels_pkg = importlib.import_module("stainx_tpu_torch.kernels")
    pages["kernels.md"] = (
        "# Kernels\n\nThe hand-written CUDA kernels for Hopper (`stainx_tpu_torch/csrc/`), "
        "built with `nvcc` at first use, each behind a wrapper that launches it on a CUDA "
        "tensor and runs its plain PyTorch version on a CPU tensor.\n\n"
        + _render_module("stainx_tpu_torch.kernels", _public_functions(kernels_pkg)) + "\n"
        + "\n".join(_render_kernel_module(f"stainx_tpu_torch.kernels.{sub}")
                    for sub in KERNEL_MODULES)
    )

    pages["io.md"] = "# IO\n\n" + _render_module("stainx_tpu_torch.io", list(io_pkg.__all__))

    prof = importlib.import_module("stainx_tpu_torch.profiling")
    pages["utils.md"] = (
        "# Utilities\n\n"
        + _render_module("stainx_tpu_torch.utils", ["get_device", "ChannelFormatConverter"]) + "\n"
        + _render_module("stainx_tpu_torch.profiling", _public_functions(prof)) + "\n"
        + _render_module("stainx_tpu_torch.convert", ["state_from_jax"])
    )

    pages = {name: HEADER + body for name, body in pages.items()}
    for name, body in pages.items():
        if ROOT in body or " at 0x" in body:
            raise ValueError(f"{name} renders a path or an address of this machine")
    return pages


def main() -> None:
    os.makedirs(OUT_DIR, exist_ok=True)
    pages = build_pages()
    for name, body in pages.items():
        with open(os.path.join(OUT_DIR, name), "w") as f:
            f.write(body)
        print(f"wrote docs_torch/api/{name} ({len(body)} bytes)")
    for name in sorted(set(os.listdir(OUT_DIR)) - set(pages)):
        print(f"stale page not regenerated: docs_torch/api/{name}")


if __name__ == "__main__":
    main()
