"""Line-by-line comparison of an example's printed output with its JAX
twin's, shared by tests/test_torch_examples_a.py and _b.py (imports no
jax). Each line is split into numbers and the text between them: the text
must be equal, integers equal, and each decimal within TOL_LOGL of its own
magnitude (the float32 budget of the examples' logLs,
bench_validate.py:61-63) plus one unit of its last printed digit (the
printing's resolution). A leading elapsed-time stamp `[  1.2s]` is dropped
from both lines."""
import importlib.util
import os
import re
import sys

TOL_LOGL = 5e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NUMBER = re.compile(r"[-+]?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")
_STAMP = re.compile(r"^\[\s*[\d.]+s\]\s*")


def jax_example(name):
    """examples/<name>.py of the JAX package, imported as a module (the
    examples are scripts, not a package), sys.path left as it was."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path        # the scripts put "." on sys.path
    return mod


def split(line):
    """(texts, numbers) of one line, its time stamp dropped."""
    line = _STAMP.sub("", line)
    return _NUMBER.split(line), _NUMBER.findall(line)


def resolution(number):
    """One unit of a printed decimal's last digit: 1e-4 for "0.1234",
    1e-7 for "1.2340e-03"."""
    mant, _, exp = number.lower().partition("e")
    digits = len(mant.partition(".")[2])
    return 10.0 ** (int(exp or 0) - digits)


def same_number(a, b):
    """Two printed numbers agree: integers equal, decimals within TOL_LOGL
    of the larger magnitude plus the coarser printing's resolution."""
    if re.fullmatch(r"[-+]?\d+", a) and re.fullmatch(r"[-+]?\d+", b):
        return int(a) == int(b)
    x, y = float(a), float(b)
    return abs(x - y) <= (TOL_LOGL * max(abs(x), abs(y))
                          + max(resolution(a), resolution(b)))


def same_line(got, want):
    """Whether two printed lines agree: equal text, every number
    `same_number`."""
    g_text, g_num = split(got)
    w_text, w_num = split(want)
    return (g_text == w_text and len(g_num) == len(w_num)
            and all(same_number(a, b) for a, b in zip(g_num, w_num)))


def assert_same_lines(got: str, want: str):
    g, w = got.splitlines(), want.splitlines()
    assert len(g) == len(w), (len(g), len(w), got, want)
    for a, b in zip(g, w):
        assert same_line(a, b), (a, b)
