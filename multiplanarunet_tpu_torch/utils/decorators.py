"""Runtime type-check decorator (port of
`multiplanarunet_tpu/utils/decorators.py`)."""

from __future__ import annotations

import functools


def accepts(*types):
    """Assert positional argument types at call time (used by setters)."""

    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            checked = args[1:] if args and hasattr(args[0], "__dict__") else args
            for value, expected in zip(checked, types):
                if not isinstance(value, expected):
                    raise TypeError(
                        f"{fn.__name__}: expected {expected} for argument "
                        f"value {value!r} (got {type(value)})"
                    )
            return fn(*args, **kwargs)

        return wrapper

    return decorator
