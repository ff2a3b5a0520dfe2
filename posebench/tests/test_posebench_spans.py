"""The program's spans (``record_function`` ranges named
``<layer>.<stage>``) in a traced run leave every count of
``trace.summarize`` as it was."""

from posebench.lib import trace


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1, "args": args}


def _launch(ts, corr):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 5, correlation=corr)


def _kernel(name, ts, dur, corr):
    return {**_x("kernel", name, ts, dur, correlation=corr), "pid": 0,
            "tid": 7}


# Calls 2 and 3 of a window [0, 2000] us. Program spans of call 2:
# api.inference [10, 990] around model.forward [20, 300], decode.greedy
# [400, 700] and api.fetch [700, 900] (sharing greedy's end); call 3:
# api.inference [1110, 1990] around decode.greedy [1200, 1800].
SPANS = [("api.inference", 10, 980), ("model.forward", 20, 280),
         ("decode.greedy", 400, 300), ("api.fetch", 700, 200),
         ("api.inference", 1110, 880), ("decode.greedy", 1200, 600)]


def _base():
    """The trace without program spans: ranges, host ops, launches, four
    kernels of the calls, one launched outside them, a blocking copy."""
    return [
        _x("user_annotation", "posebench#2", 0, 1000),
        _x("user_annotation", "posebench#3", 1100, 900),
        _x("cpu_op", "aten::conv2d", 25, 270),
        _x("cpu_op", "aten::item", 410, 280),
        _launch(30, 1), _kernel("conv", 100, 100, 1),
        _launch(450, 2), _kernel("greedy_round", 500, 100, 2),
        _launch(710, 3), _x("gpu_memcpy", "Memcpy DtoH", 750, 50,
                            correlation=3),
        _x("cuda_runtime", "cudaMemcpy", 712, 90, correlation=3),
        _launch(1210, 4), _kernel("greedy_round", 1300, 100, 4),
        _launch(1040, 5), _kernel("warm", 1050, 10, 5),
        _x("cuda_runtime", "cudaStreamSynchronize", 1500, 10,
           correlation=6),
    ]


def _with_spans():
    events = _base()
    for k, (name, ts, dur) in enumerate(SPANS):
        events.append(_x("user_annotation", name, ts, dur))
        # the device lane's mirror of a range that holds device work
        events.append({"ph": "X", "cat": "gpu_user_annotation",
                       "name": name, "ts": ts + 60, "dur": dur,
                       "pid": 0, "tid": 7, "args": {"External id": k}})
    return events


def test_trace_summary_is_unchanged_by_program_spans():
    """The golden check: every key ``trace.summarize`` had, computed the
    same with the program's spans and their device mirrors in the
    trace."""
    without = trace.summarize(_base())
    assert without["syncs"] == 2 and without["kernels"] == 3
    assert trace.summarize(_with_spans()) == without
    assert set(trace.breakdown(without)) == {"device_ops", "idle_gaps"}
