""".pbrt scene-file tokenizer + recursive-descent parser.

Replaces the reference's flex/bison front end (core/pbrtlex.ll,
core/pbrtparse.yy, core/parser.cpp) with a hand-rolled Python parser
that maps every statement to the matching `pbrt_*` function of
pbrt_tpu_torch.scene.api — same 36-statement surface, same parameter
declaration syntax ("type name" strings with scalar-or-bracketed
values), same Include semantics (nested file stack).
"""
from __future__ import annotations

import os
import re
from typing import Iterator, List, Union

from pbrt_tpu_torch.core.error import PbrtError
from pbrt_tpu_torch.scene.paramset import PARAM_TYPES, ParamSet

Token = Union[str, float]

_TOKEN_RE = re.compile(
    r"""
    \s*(?:
        (?P<comment>\#[^\n]*) |
        (?P<string>"(?:[^"\\]|\\.)*") |
        (?P<lbrack>\[) |
        (?P<rbrack>\]) |
        (?P<number>[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?) |
        (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
    )
    """,
    re.VERBOSE,
)


class _QuotedString(str):
    """Marker type distinguishing "quoted" strings from bare identifiers."""


def tokenize(text: str) -> Iterator[Token]:
    pos = 0
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            if text[pos:].strip() == "":
                return
            raise PbrtError(f"lex error near: {text[pos:pos+40]!r}")
        pos = m.end()
        if m.lastgroup == "comment":
            continue
        if m.lastgroup == "string":
            yield _QuotedString(m.group("string")[1:-1])
        elif m.lastgroup == "number":
            yield float(m.group("number"))
        elif m.lastgroup == "lbrack":
            yield "["
        elif m.lastgroup == "rbrack":
            yield "]"
        elif m.lastgroup == "ident":
            yield m.group("ident")


class _TokenStream:
    """Token stream with one-token lookahead and an Include file stack."""

    def __init__(self, path: str):
        self.stack: List[Iterator[Token]] = []
        self.peeked: List[Token] = []
        self.push_file(path)
        self.search_dir = os.path.dirname(os.path.abspath(path))

    def push_file(self, path: str):
        with open(path) as f:
            self.stack.append(tokenize(f.read()))

    def next(self):
        if self.peeked:
            return self.peeked.pop()
        while self.stack:
            try:
                return next(self.stack[-1])
            except StopIteration:
                self.stack.pop()
        return None

    def peek(self):
        if not self.peeked:
            t = self.next()
            if t is None:
                return None
            self.peeked.append(t)
        return self.peeked[-1]

    def push_back(self, tok):
        self.peeked.append(tok)


_STATEMENTS = {
    "Accelerator", "ActiveTransform", "AreaLightSource", "AttributeBegin",
    "AttributeEnd", "Camera", "ConcatTransform", "CoordinateSystem",
    "CoordSysTransform", "Film", "Identity", "Include", "LightSource",
    "LookAt", "MakeNamedMaterial", "Material", "NamedMaterial",
    "ObjectBegin", "ObjectEnd", "ObjectInstance", "PixelFilter", "Renderer",
    "ReverseOrientation", "Rotate", "Sampler", "Scale", "Shape",
    "SurfaceIntegrator", "Texture", "TransformBegin", "TransformEnd",
    "Transform", "TransformTimes", "Translate", "Volume",
    "VolumeIntegrator", "WorldBegin", "WorldEnd",
}


def _expect_number(ts: _TokenStream, what: str) -> float:
    t = ts.next()
    if not isinstance(t, float):
        raise PbrtError(f"expected number for {what}, got {t!r}")
    return t


def _expect_string(ts: _TokenStream, what: str) -> str:
    t = ts.next()
    if not isinstance(t, _QuotedString):
        raise PbrtError(f'expected quoted string for {what}, got {t!r}')
    return str(t)


def _numbers(ts: _TokenStream, n: int, what: str) -> List[float]:
    # pbrt allows optional brackets around fixed number lists
    bracket = ts.peek() == "["
    if bracket:
        ts.next()
    vals = [_expect_number(ts, what) for _ in range(n)]
    if bracket:
        if ts.next() != "]":
            raise PbrtError(f"expected ] after {what}")
    return vals


def _param_value_list(ts: _TokenStream):
    if ts.peek() == "[":
        ts.next()
        vals = []
        while True:
            t = ts.peek()
            if t == "]":
                ts.next()
                return vals
            if t is None:
                raise PbrtError("unterminated [ parameter list")
            t = ts.next()
            if isinstance(t, _QuotedString):
                vals.append(str(t))
            elif isinstance(t, float):
                vals.append(t)
            elif t in ("true", "false"):
                vals.append(t == "true")
            else:
                raise PbrtError(f"unexpected token in parameter list: {t!r}")
        # unreachable
    t = ts.next()
    if isinstance(t, _QuotedString):
        return [str(t)]
    if isinstance(t, float):
        return [t]
    if t in ("true", "false"):
        return [t == "true"]
    raise PbrtError(f"unexpected parameter value: {t!r}")


def _params(ts: _TokenStream) -> ParamSet:
    ps = ParamSet(search_dir=ts.search_dir)
    while isinstance(ts.peek(), _QuotedString):
        decl = str(ts.next()).split()
        if len(decl) != 2 or decl[0] not in PARAM_TYPES:
            raise PbrtError(f'bad parameter declaration "{" ".join(decl)}"')
        decl_type, name = decl
        ps.add(decl_type, name, _param_value_list(ts))
    return ps


def parse_file(path: str, api=None):
    """Parse a .pbrt file, driving the api state machine.

    api defaults to the module pbrt_tpu_torch.scene.api (reference
    core/parser.cpp ParseFile -> yyparse -> pbrt*()).
    """
    if api is None:
        from pbrt_tpu_torch.scene import api as api_mod

        api = api_mod
    ts = _TokenStream(path)
    while True:
        tok = ts.next()
        if tok is None:
            break
        if isinstance(tok, _QuotedString) or isinstance(tok, float):
            raise PbrtError(f"expected statement, got {tok!r}")
        stmt = str(tok)
        if stmt not in _STATEMENTS:
            raise PbrtError(f"unknown statement {stmt!r}")
        if stmt == "Include":
            inc = _expect_string(ts, "Include")
            if not os.path.isabs(inc):
                inc = os.path.join(ts.search_dir, inc)
            ts.push_file(inc)
        elif stmt == "AttributeBegin":
            api.pbrt_attribute_begin()
        elif stmt == "AttributeEnd":
            api.pbrt_attribute_end()
        elif stmt == "TransformBegin":
            api.pbrt_transform_begin()
        elif stmt == "TransformEnd":
            api.pbrt_transform_end()
        elif stmt == "ObjectBegin":
            api.pbrt_object_begin(_expect_string(ts, "ObjectBegin"))
        elif stmt == "ObjectEnd":
            api.pbrt_object_end()
        elif stmt == "ObjectInstance":
            api.pbrt_object_instance(_expect_string(ts, "ObjectInstance"))
        elif stmt == "WorldBegin":
            api.pbrt_world_begin()
        elif stmt == "WorldEnd":
            api.pbrt_world_end()
        elif stmt == "ReverseOrientation":
            api.pbrt_reverse_orientation()
        elif stmt == "Identity":
            api.pbrt_identity()
        elif stmt == "Translate":
            api.pbrt_translate(*_numbers(ts, 3, "Translate"))
        elif stmt == "Scale":
            api.pbrt_scale(*_numbers(ts, 3, "Scale"))
        elif stmt == "Rotate":
            api.pbrt_rotate(*_numbers(ts, 4, "Rotate"))
        elif stmt == "LookAt":
            v = _numbers(ts, 9, "LookAt")
            api.pbrt_look_at(v[0:3], v[3:6], v[6:9])
        elif stmt == "Transform":
            api.pbrt_transform(_numbers(ts, 16, "Transform"))
        elif stmt == "ConcatTransform":
            api.pbrt_concat_transform(_numbers(ts, 16, "ConcatTransform"))
        elif stmt == "TransformTimes":
            api.pbrt_transform_times(*_numbers(ts, 2, "TransformTimes"))
        elif stmt == "ActiveTransform":
            which = str(ts.next())
            api.pbrt_active_transform(which)
        elif stmt == "CoordinateSystem":
            api.pbrt_coordinate_system(_expect_string(ts, "CoordinateSystem"))
        elif stmt == "CoordSysTransform":
            api.pbrt_coord_sys_transform(_expect_string(ts, "CoordSysTransform"))
        elif stmt == "NamedMaterial":
            api.pbrt_named_material(_expect_string(ts, "NamedMaterial"))
        elif stmt == "Texture":
            name = _expect_string(ts, "Texture name")
            tex_type = _expect_string(ts, "Texture type")
            tex_class = _expect_string(ts, "Texture class")
            api.pbrt_texture(name, tex_type, tex_class, _params(ts))
        elif stmt == "MakeNamedMaterial":
            name = _expect_string(ts, "MakeNamedMaterial")
            api.pbrt_make_named_material(name, _params(ts))
        else:
            # all remaining statements: "name" + params
            name = _expect_string(ts, stmt)
            fn = {
                "Accelerator": api.pbrt_accelerator,
                "AreaLightSource": api.pbrt_area_light_source,
                "Camera": api.pbrt_camera,
                "Film": api.pbrt_film,
                "LightSource": api.pbrt_light_source,
                "Material": api.pbrt_material,
                "PixelFilter": api.pbrt_pixel_filter,
                "Renderer": api.pbrt_renderer,
                "Sampler": api.pbrt_sampler,
                "Shape": api.pbrt_shape,
                "SurfaceIntegrator": api.pbrt_surface_integrator,
                "Volume": api.pbrt_volume,
                "VolumeIntegrator": api.pbrt_volume_integrator,
            }[stmt]
            fn(name, _params(ts))
