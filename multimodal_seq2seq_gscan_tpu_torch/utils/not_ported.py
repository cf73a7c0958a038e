"""The refusal of an option whose JAX counterpart the port does not have
yet: raised by name, never substituted or ignored."""


def not_ported(what: str, item: str):
    """Raise ``NotImplementedError`` naming ``what`` and its ROADMAP item."""
    raise NotImplementedError("{} is not ported yet (ROADMAP {})".format(
        what, item))
