from .spec_compiler import (  # noqa: F401
    build_spec,
    get_spec,
    parse_spec_markdown,
    render_spec_source,
)
