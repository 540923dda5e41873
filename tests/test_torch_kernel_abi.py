"""The C interface of the port's native libraries: every entry point that
ops/cuda.py's ENTRIES types for ctypes against the ``extern "C"`` prototype
in its csrc/ source, parameter by parameter. A wrong ctypes type garbles
its argument silently, which would show only on the card; this reads the
sources and needs no compiler."""

import ctypes
import re

import pytest

from dreamfusion_torch.ops import cuda

# a C parameter's type (after the pointer test) -> its kind
C_KINDS = {"int": "int32", "int32_t": "int32", "int64_t": "int64",
           "long long": "int64", "float": "float"}


def _strip_comments(text: str) -> str:
    return re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S)


def _flat(text: str, start: int) -> str:
    """The text from `start` (just inside a brace) to its closing brace
    with every nested brace body cut out and a ';' in its place: what is
    left are the block's own declarations."""
    depth, out = 0, []
    for c in text[start:]:
        if c == "{":
            depth += 1
        elif c == "}":
            if depth == 0:
                break
            depth -= 1
            if depth == 0:
                out.append(";")
        elif depth == 0:
            out.append(c)
    return "".join(out)


def extern_c_prototypes(text: str):
    """{name: (return type, [parameter declarations])} of the functions a
    C++ source defines with C linkage: ``extern "C" int f(...)`` and the
    functions of an ``extern "C" { ... }`` block (not those in a namespace
    inside it)."""
    text = _strip_comments(text)
    decls = []
    for m in re.finditer(r'extern\s+"C"\s*(\{)?', text):
        if m.group(1):
            decls.append(_flat(text, m.end()))
        else:
            decls.append(text[m.end():text.index("{", m.end())] + ";")
    found = {}
    for block in decls:
        for ret, name, params in re.findall(
                r"([A-Za-z_][\w ]*?[\w*])\s*\b(\w+)\s*\(([^)]*)\)\s*;", block):
            found[name] = (ret.strip(), [p.strip() for p in params.split(",")
                                         if p.strip()])
    return found


def c_kind(decl: str) -> str:
    """pointer / int32 / int64 / float of one C parameter declaration."""
    if "*" in decl:
        return "pointer"
    words = decl.replace("const ", "").split()
    return C_KINDS[" ".join(words[:-1])]


def ctypes_kind(t) -> str:
    """The same kinds of one ctypes type."""
    if t is ctypes.c_void_p or issubclass(t, ctypes._Pointer):
        return "pointer"
    if t is ctypes.c_float:
        return "float"
    if t._type_ in "bhilqBHILQ":
        return f"int{8 * ctypes.sizeof(t)}"
    raise AssertionError(f"no C kind for {t}")


def _source_prototypes(library: str):
    return extern_c_prototypes(
        (cuda.CSRC_DIR / cuda.SOURCES[library]).read_text())


@pytest.mark.parametrize("symbol", list(cuda.ENTRIES))
def test_argtypes_match_the_c_prototype(symbol):
    """The entry's ctypes parameters have the kinds of its prototype's,
    one by one and as many, in the source of its library; it returns int."""
    entry = cuda.ENTRIES[symbol]
    protos = _source_prototypes(entry.library)
    assert symbol in protos, (symbol, cuda.SOURCES[entry.library])
    ret, params = protos[symbol]
    assert ret == "int"     # library() types every entry to return c_int
    assert len(entry.argtypes) == len(params), (symbol, params)
    for i, (t, decl) in enumerate(zip(entry.argtypes, params)):
        assert ctypes_kind(t) == c_kind(decl), (symbol, i, decl, t)


def test_every_extern_c_function_is_registered():
    """ENTRIES holds every function with C linkage in csrc/, each under the
    library built from its source; launch_counts has one key per counted
    kernel, and only the host library's functions and attention's delta
    pass (counted by attention_bwd's wrapper) count nothing."""
    for library, src in cuda.SOURCES.items():
        protos = _source_prototypes(library)
        assert protos, src
        registered = {s for s, e in cuda.ENTRIES.items()
                      if e.library == library}
        assert registered == set(protos), (src, set(protos) ^ registered)
    assert list(cuda.launch_counts) == [
        "grid_encoder_bwd", "grid_encoder_bwd_rows", "grid_encoder_fwd",
        "composite_fwd", "composite_bwd", "composite_compact", "attention_fwd",
        "attention_bwd", "probe_select_small", "march_cone", "march_window",
        "grid_sample_fwd", "grid_sample_bwd"]
    assert {s for s, e in cuda.ENTRIES.items() if e.counter is None} == {
        "marching_tetrahedra", "rasterize_uv", "nearest_inpaint",
        "attention_bwd_delta"}


def test_prototype_reader_sees_both_forms_and_skips_namespaces():
    """The reader on a source written for it: a one-line ``extern "C"``
    function, a block whose anonymous namespace holds a helper, comments
    holding a decoy prototype; the kinds of each parameter."""
    text = '''
    // extern "C" int decoy(int a);
    namespace { __global__ void k(float* x) { if (x) { x[0] = 1.f; } } }
    extern "C" int one(const void* a, int n, long long m, float s,
                       void* stream) {
      return n > 0 ? 0 : 1;
    }
    extern "C" {
    namespace { inline int helper(int a) { return a; } }
    /* int decoy2(float f); */
    int two(const float* g, int64_t n, int32_t* out) { return helper(0); }
    }
    '''
    protos = extern_c_prototypes(text)
    assert set(protos) == {"one", "two"}
    assert [c_kind(p) for p in protos["one"][1]] == [
        "pointer", "int32", "int64", "float", "pointer"]
    assert [c_kind(p) for p in protos["two"][1]] == [
        "pointer", "int64", "pointer"]
    assert [ctypes_kind(t) for t in (ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int64, ctypes.c_longlong,
                                     ctypes.c_float,
                                     ctypes.POINTER(ctypes.c_uint8))] == [
        "pointer", "int32", "int64", "int64", "float", "pointer"]
