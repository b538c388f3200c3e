from .parser import (  # noqa: F401
    GTScriptDefinitionError,
    GTScriptSyntaxError,
    parse_definition,
)
