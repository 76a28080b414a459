"""The port's desc-based observability tools against the JAX package's:
``debugger.draw_program`` (with the verifier's diagnostics annotated),
``draw_block_graphviz`` and ``pprint_program_codes``,
``contrib.memory_usage_calc.memory_usage`` and
``contrib.op_frequence.op_freq_statistic``, and the ``graph_viz_pass``
dump. Each program is built by the same code in both packages (``fl`` is
either); the outputs are byte-identical. tests/test_verify.py's
``test_draw_program_annotates_offenders`` is carried over.
"""

import io
from contextlib import redirect_stdout

import pytest

import paddle_tpu as fluid
from paddle_tpu.contrib import memory_usage_calc as jmemuse
from paddle_tpu.contrib import op_frequence as jopfreq
from paddle_tpu import debugger as jdebugger
from paddle_tpu.core.types import DataType as JDataType
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch.contrib import memory_usage_calc as pmemuse
from paddle_tpu_torch.contrib import op_frequence as popfreq
from paddle_tpu_torch import debugger as pdebugger
from paddle_tpu_torch.core.types import DataType as PDataType
from paddle_tpu_torch.utils.flags import FLAGS as PFLAGS

PKGS = {"jax": (fluid, jdebugger, jmemuse, jopfreq, JDataType),
        "port": (pt, pdebugger, pmemuse, popfreq, PDataType)}


@pytest.fixture(autouse=True)
def _no_callstacks():
    old = JFLAGS.op_callstack, PFLAGS.op_callstack
    JFLAGS.op_callstack = PFLAGS.op_callstack = False
    yield
    JFLAGS.op_callstack, PFLAGS.op_callstack = old


def tiny_train(fl):
    with fl.unique_name.guard():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = fl.layers.data("x", shape=[6], dtype="float32")
            y = fl.layers.data("y", shape=[1], dtype="float32")
            h = fl.layers.fc(x, size=8, act="relu")
            h = fl.layers.dropout(h, dropout_prob=0.1)
            p = fl.layers.fc(h, size=1)
            loss = fl.layers.reduce_mean(fl.layers.square_error_cost(p, y))
            fl.optimizer.SGD(0.01).minimize(loss)
    return main, startup, loss


def tiny_conv(fl):
    with fl.unique_name.guard():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            img = fl.layers.data("img", shape=[3, 16, 16], dtype="float32")
            label = fl.layers.data("label", shape=[1], dtype="int64")
            c = fl.layers.conv2d(img, num_filters=4, filter_size=3,
                                 padding=1, act="relu")
            c = fl.layers.batch_norm(c)
            p = fl.layers.pool2d(c, pool_size=2, pool_stride=2)
            logits = fl.layers.fc(p, size=10)
            loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(
                logits, label))
            fl.optimizer.Momentum(0.01, momentum=0.9).minimize(loss)
    return main, startup, loss


def tiny_transformer(fl):
    from paddle_tpu.models import transformer as jt
    from paddle_tpu_torch.models import transformer as ptm
    cfg = dict(src_vocab=30, tgt_vocab=30, max_len=8, n_layer=1, n_head=2,
               d_model=16, d_inner_hid=32)
    with fl.unique_name.guard():
        if fl is fluid:
            m = jt.build(dropout_rate=0.0, **cfg)
        else:
            m = ptm.build(**cfg)
    return m["main"], m["startup"], m["loss"]


BUILDS = {"train": tiny_train, "conv": tiny_conv,
          "transformer": tiny_transformer}


def _each(build, fn):
    """fn(fl, debugger, memuse, opfreq, dtypes, main) in both packages."""
    out = {}
    for name, (fl, dbg, mu, of, dt) in PKGS.items():
        main = build(fl)[0]
        out[name] = fn(fl, dbg, mu, of, dt, main)
    return out["jax"], out["port"]


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_draw_program_dot_is_byte_identical(build):
    j, p = _each(BUILDS[build], lambda fl, dbg, mu, of, dt, main:
                 dbg.draw_program(main))
    assert p == j and p.startswith("digraph program {")


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_pprint_program_codes_is_byte_identical(build):
    def run(fl, dbg, mu, of, dt, main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            text = dbg.pprint_program_codes(main)
        return text, buf.getvalue()

    j, p = _each(BUILDS[build], run)
    assert p == j and "-- block 0 --" in p[0]


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_draw_block_graphviz_is_byte_identical(build, tmp_path):
    def run(fl, dbg, mu, of, dt, main):
        path = str(tmp_path / f"{fl.__name__}.dot")
        dbg.draw_block_graphviz(main.global_block(),
                                highlights=["fc_0"], path=path)
        return open(path).read()

    j, p = _each(BUILDS[build], run)
    assert p == j and "fillcolor=red" in p


@pytest.mark.parametrize("batch", [1, 32, 500])
@pytest.mark.parametrize("build", sorted(BUILDS))
def test_memory_usage_equals_jax(build, batch):
    j, p = _each(BUILDS[build], lambda fl, dbg, mu, of, dt, main:
                 mu.memory_usage(main, batch_size=batch))
    assert p == j


def test_memory_usage_rejects_what_jax_rejects():
    for name, (fl, dbg, mu, of, dt) in PKGS.items():
        main = tiny_train(fl)[0]
        with pytest.raises(ValueError):
            mu.memory_usage(main, batch_size=0)
        with pytest.raises(TypeError):
            mu.memory_usage("not a program", batch_size=1)


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_op_freq_statistic_equals_jax(build):
    j, p = _each(BUILDS[build], lambda fl, dbg, mu, of, dt, main:
                 tuple(list(d.items())
                       for d in of.op_freq_statistic(main)))
    assert p == j and p[0]


def test_draw_program_annotates_offenders(tmp_path):
    """tests/test_verify.py's case on the port, and the same text as the
    JAX package's for the same broken program."""
    def broken(fl, dbg, mu, of, dt, main):
        blk = main.global_block().desc
        name = next(n for n in blk.vars if n.endswith("fc_0.tmp_0"))
        blk.vars[name].dtype = dt.INT32
        path = str(tmp_path / f"{fl.__name__}.dot")
        dot = dbg.draw_program(main, path=path, feed_names=["x", "y"])
        assert open(path).read() == dot
        return dot

    j, p = _each(tiny_train, broken)
    assert p == j
    assert "tomato" in p and "dtype_mismatch" in p
    clean = pdebugger.draw_program(tiny_train(pt)[0], feed_names=["x", "y"])
    assert "tomato" not in clean and "digraph" in clean


def test_graph_viz_pass_writes_the_same_dump(tmp_path, monkeypatch):
    from paddle_tpu import ir as jir
    from paddle_tpu_torch import ir as pir
    dumps = {}
    for name, ir in (("jax", jir), ("port", pir)):
        fl = PKGS[name][0]
        main = tiny_conv(fl)[0]
        p = ir.passes.get_pass("graph_viz_pass")
        p.set("graph_viz_path", str(tmp_path / f"{name}.dot"))
        p.apply(ir.graph.Graph(main, 0))
        dumps[name] = (tmp_path / f"{name}.dot").read_text()
    assert dumps["port"] == dumps["jax"] and "->" in dumps["port"]
