"""Helper functions for using operators.

Reference parity: upstream bytewax ``pysrc/bytewax/operators/helpers.py``.
"""

from typing import Callable, Dict, TypeVar

K = TypeVar("K")
V = TypeVar("V")

__all__ = ["map_dict_value"]


def map_dict_value(
    key: K, mapper: Callable[[V], V]
) -> Callable[[Dict[K, V]], Dict[K, V]]:
    """Build a mapper that transforms one value in a dict item,
    leaving the rest untouched (a simple lens).

    >>> mapper = map_dict_value("name", str.upper)
    >>> mapper({"name": "ada", "id": 1})
    {'name': 'ADA', 'id': 1}

    This "operate on one spot of a known nested structure" pattern is
    a **lens**; for richer lenses (attributes vs keys, immutability)
    see the ``lenses`` package — its mappers compose with
    :func:`bytewax_tpu_torch.operators.map` the same way.

    :arg key: Dictionary key.
    :arg mapper: Function to run on the value for that key.
    :returns: A function suitable for
        :func:`bytewax_tpu_torch.operators.map`.
    """

    def shim_mapper(obj: Dict[K, V]) -> Dict[K, V]:
        obj[key] = mapper(obj[key])
        return obj

    return shim_mapper
