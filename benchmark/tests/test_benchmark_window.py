"""The window's rate and tail on synthetic job times, and the idle-gap
attribution of a traced run."""

import statistics

import pytest

from benchmark.harness import Job, idle_gaps, innermost, run_window, window_metrics


class FakeClock:
    """A clock that a job moves forward by its own duration."""

    def __init__(self, durations):
        self.t = 100.0
        self.durations = list(durations)
        self.calls = 0

    def __call__(self):
        return self.t

    def job(self):
        self.t += self.durations[self.calls]
        self.calls += 1
        return self.calls


def test_window_that_ends_mid_job_counts_the_job_whole():
    clock = FakeClock([0.4, 0.4, 0.4, 0.4, 9.0])
    jobs = run_window(clock.job, 1.0, clock=clock)
    # jobs start at 0, 0.4, 0.8; the third runs past 1.0 and is counted
    assert [round(j.start, 6) for j in jobs] == [0.0, 0.4, 0.8]
    assert round(jobs[-1].end, 6) == 1.2
    m = window_metrics(jobs, values_per_job=10)
    assert m["values_per_s"] == pytest.approx(30 / 1.2)
    assert m["window_s"] == pytest.approx(1.2)


def test_rate_is_all_work_over_all_time_and_the_tail_is_of_all_jobs():
    durs = [0.1] * 19 + [0.5]
    t, jobs = 0.0, []
    for d in durs:
        jobs.append(Job(t, t + d, result=object()))
        t += d
    m = window_metrics(jobs, values_per_job=1000)
    assert m["values_per_s"] == pytest.approx(20 * 1000 / 2.4)
    want = statistics.quantiles([d * 1e3 for d in durs], n=20, method="inclusive")[-1]
    assert m["job_p95_ms"] == pytest.approx(want)
    assert 100 < m["job_p95_ms"] < 500


def test_a_failed_job_is_not_work_but_takes_time():
    jobs = [Job(0.0, 1.0, result=object()), Job(1.0, 2.0, error="boom")]
    m = window_metrics(jobs, values_per_job=10)
    assert m["values_per_s"] == pytest.approx(10 / 2.0)


def test_failed_jobs_are_recorded_and_the_window_goes_on():
    clock = FakeClock([0.3] * 10)

    def job():
        n = clock.job()
        if n == 2:
            raise RuntimeError("boom")
        return n

    jobs = run_window(job, 1.0, clock=clock)
    assert [j.error is None for j in jobs] == [True, False, True, True]


def test_innermost_pieces_of_nested_spans():
    pieces = innermost([(0, 10, "job"), (2, 5, "prep"), (6, 8, "kernel"),
                        (12, 13, "merge")])
    assert pieces == [(0, 2, "job"), (2, 5, "prep"), (5, 6, "job"),
                      (6, 8, "kernel"), (8, 10, "job"), (12, 13, "merge")]


def test_idle_gaps_by_host_span():
    pieces = [(0.0, 2.0, "prep"), (2.0, 3.0, "dispatch")]
    busy = [(1.0, 1.5), (2.5, 4.0)]
    gaps = idle_gaps(busy, 5.0, pieces)
    assert gaps == pytest.approx({"prep": 1.5, "dispatch": 0.5, "_no_span_": 1.0})
