"""The reader of the refit's interior pass, ``refit_nodes_ms``, on
synthetic traces: a sync inside the pass, and a refit without the pass."""

import pytest

from rtbench import core
from rtbench.measure import Trace


def _read(name, *traces):
    run = core.Run(setup_s=1.0, window_s=1.0, calls=[], traces=list(traces))
    return core.reader(name).read(run)


# two calls over 0-10 s: the card busy 0-2 and 4-6; a train step 1-5 whose
# refit runs 1-2, and a sync 3.1-3.3 outside the refit
DEVICE = [("render_fwd_kernel", 0.0, 2.0), ("render_vjp", 4.0, 6.0)]
HOST = [("raytpu.train_step", 1.0, 5.0), ("raytpu.refit", 1.0, 2.0),
        ("cudaStreamSynchronize", 3.1, 3.3)]


def test_refit_nodes_net_of_a_sync():
    # the interior pass 1.2-1.8 s inside the refit, a sync 1.3-1.4 s in
    # it: 0.5 s over 2 calls
    inner = Trace(DEVICE, HOST + [("raytpu.refit_nodes", 1.2, 1.8),
                                  ("cudaStreamSynchronize", 1.3, 1.4)],
                  0.0, 10.0, 2)
    assert _read("refit_nodes_ms.fit", inner) == pytest.approx(
        1e3 * 0.5 / 2)


@pytest.mark.parametrize("host", [HOST, []], ids=["refit", "no_spans"])
def test_nothing_without_the_pass(host):
    # a refit without the pass (a program that voids the interior boxes),
    # and a trace without the program's spans
    assert _read("refit_nodes_ms.fit", Trace(DEVICE, host, 0.0, 10.0, 2)) \
        is None
