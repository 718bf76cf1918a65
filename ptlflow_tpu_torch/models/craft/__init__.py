from .craft import CRAFT, craft  # noqa: F401
