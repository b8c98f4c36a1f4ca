"""Host seconds from the first statement of ``gxbench/run.py`` to the
end of the first steps (the extension's load or build, the Trainer, the
weights, the warm-up steps the reference later follows)."""


def read(run):
    return run.out.setup_s
