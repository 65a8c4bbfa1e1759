"""JAX's checkpoint files in the port (counterpart of
``endosr/utils/checkpoint.py``, with its names).

The JAX package writes flax msgpack files: the weights as
``{iter}_{label}.ckpt`` (a flax parameter tree) and the trainer state as
``{iter}.state`` (``{epoch, iter, opt_state, params}``). This module reads
and writes those files without JAX (``utils/msgpack_io.py``); trees are
nested dicts of numpy arrays (a bfloat16 leaf is a ``torch.bfloat16``
tensor). ``utils/port_params.py`` maps them to and from the port's
``state_dict`` names and layouts, ``utils/optim_state.py`` the optimizer
states.

The backend is read as JAX reads it: a model's ``path.checkpoint_backend``,
then ``ENDOSR_CKPT_BACKEND`` (or :func:`set_backend`). ``msgpack`` writes
JAX's files. Unset, the port's models keep their own ``.pth`` files (a
deliberate difference from JAX, whose default is ``msgpack``). ``orbax``
(a directory of tensorstore's OCDBT layout) is not read or written here:
it raises ``NotImplementedError``, and so does loading a directory. A save
writes a ``.tmp`` file and renames it into place; under
``torch.distributed`` only rank 0 writes, and every rank can read.
"""

from __future__ import annotations

import os

from endosr_torch.utils.msgpack_io import packb, unpackb

__all__ = ["save_pytree", "load_pytree", "save_network", "load_network",
           "save_training_state", "load_training_state", "set_backend",
           "backend_of", "is_torch_file"]

_BACKEND = os.environ.get("ENDOSR_CKPT_BACKEND") or None
_ORBAX = ("the orbax checkpoint backend (a directory in tensorstore's OCDBT "
          "layout) is not ported: save with checkpoint_backend: msgpack, "
          "which the JAX package reads and writes too")


def set_backend(name: str | None) -> None:
    """Set the process default backend, ``msgpack`` or ``orbax`` (None
    leaves it); a model's ``path.checkpoint_backend`` comes first."""
    global _BACKEND
    if name:
        if name not in ("msgpack", "orbax"):
            raise ValueError(f"checkpoint backend [{name}]: msgpack or orbax")
        _BACKEND = name


def backend_of(name: str | None = None) -> str | None:
    """The backend a save takes: ``name`` (a model's
    ``path.checkpoint_backend``), else the process default; ``"msgpack"``
    or None (unset: the port's ``.pth`` files). ``orbax`` raises
    ``NotImplementedError``."""
    name = name or _BACKEND
    if name == "orbax":
        raise NotImplementedError(_ORBAX)
    if name not in (None, "msgpack"):
        raise ValueError(f"checkpoint backend [{name}]: msgpack or orbax")
    return name


def _rank0() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or \
        dist.get_rank() == 0


def save_pytree(tree, path: str, backend: str | None = None) -> str:
    """Write ``tree`` as flax's msgpack bytes to ``path`` (through
    ``path.tmp``); returns ``path``."""
    backend_of(backend)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(packb(tree))
    os.replace(tmp, path)
    return path


def load_pytree(path: str):
    """The tree a msgpack ``.ckpt`` / ``.state`` holds (nested dicts). A
    directory (an orbax checkpoint) raises ``NotImplementedError``."""
    if os.path.isdir(path):
        raise NotImplementedError(f"{path}: {_ORBAX}")
    with open(path, "rb") as f:
        data = f.read()
    if is_torch_file(data[:4]):
        raise ValueError(f"{path} is a torch file, not a flax msgpack one")
    try:
        tree = unpackb(data)
    except (ValueError, KeyError, IndexError, UnicodeDecodeError) as e:
        raise ValueError(f"{path}: not a flax msgpack checkpoint ({e})") from e
    return tree


def is_torch_file(head: bytes) -> bool:
    """Whether a file that starts with ``head`` is a ``torch.save`` zip
    (``PK\\x03\\x04``); anything else is read as msgpack."""
    return bytes(head[:4]) == b"PK\x03\x04"


def save_network(params, save_dir: str, network_label: str, iter_label,
                 backend: str | None = None) -> str:
    """``{iter}_{label}.ckpt`` in ``save_dir`` (rank 0 writes); returns
    its path."""
    path = os.path.join(save_dir, f"{iter_label}_{network_label}.ckpt")
    if _rank0():
        save_pytree(params, path, backend)
    return path


def load_network(load_path: str):
    """The flax parameter tree of a ``.ckpt``."""
    return load_pytree(load_path)


def save_training_state(state, save_dir: str, iter_label,
                        backend: str | None = None) -> str:
    """``{iter}.state`` in ``save_dir`` (rank 0 writes); returns its
    path."""
    path = os.path.join(save_dir, f"{iter_label}.state")
    if _rank0():
        save_pytree(state, path, backend)
    return path


def load_training_state(path: str):
    """The ``{epoch, iter, opt_state, params}`` tree of a ``.state``."""
    return load_pytree(path)
