"""Set-up: from the harness's first line to the window's start (loading,
generating the graph, building the version, kernel builds, warm-up)."""


def read(run, name):
    return run["setup_s"]
