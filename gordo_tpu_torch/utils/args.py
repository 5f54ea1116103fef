"""
``capture_args``, a copy of ``gordo_tpu/utils/args.py``: an ``__init__``
decorator that keeps the bound call arguments, defaults included, as
``self._params``, so that ``to_dict`` writes what the object was made
from.

>>> class Thing:
...     @capture_args
...     def __init__(self, a, b=2, **kwargs):
...         pass
>>> Thing(1, extra="x")._params
{'a': 1, 'b': 2, 'extra': 'x'}
"""

import functools
import inspect


def capture_args(method):
    signature = inspect.signature(method)

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        bound = signature.bind(self, *args, **kwargs)
        bound.apply_defaults()
        params = {}
        for name, value in bound.arguments.items():
            kind = signature.parameters[name].kind
            if name == "self":
                continue
            if kind is inspect.Parameter.VAR_POSITIONAL:
                params["args"] = list(value)
            elif kind is inspect.Parameter.VAR_KEYWORD:
                params.update(value)
            else:
                params[name] = value
        self._params = params
        return method(self, *args, **kwargs)

    return wrapper
