from .painless_lite import CompiledScript, compile_script  # noqa: F401
