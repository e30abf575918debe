"""The candidates the mesh seeder's selection kept (the program's counter
``seed.selected``, each one a lane for the extender) per read of the
traced window.  None where the program keeps no such counter."""

from portbench.program_trace import counts


def read(ctx):
    c = counts()
    if "seed.selected" not in c or not ctx["units"]:
        return None
    return c["seed.selected"] / ctx["units"]
