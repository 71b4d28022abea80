"""Model logging: structured sections into `model.log`, byte for byte the
JAX package's.

The section vocabulary and shapes of the reference's `log()`
(`fedm/file_io.py:634-724`): 'properties', 'conditions', 'matrices',
'initial time', 'time', 'mesh'. Only process zero writes
(`utils.process`).
"""

from __future__ import annotations

from textwrap import dedent

import numpy as np

from ..utils.process import is_process_zero


def numpy_2d_array_to_str(x) -> str:
    no_brackets = str(np.asarray(x)).replace("[", "").replace("]", "")
    return "\n".join(y.strip() for y in no_brackets.split("\n"))


def log(log_type: str, log_file_name, *args) -> None:
    if not is_process_zero():
        return

    if log_type == "properties":
        gas, model, particle_species_file_names, M, charge = args
        log_str = dedent(
            f"""\
            Gas:\t{gas}

            model:\t{model}

            Particle names:
            {particle_species_file_names}

            Mass:
            {M}

            Charge:
            {charge}
            """
        )
    elif log_type == "conditions":
        dt_var, U_w, p0, gap_length, N0, Tgas = args
        log_str = dedent(
            f"""\
            dt = {dt_var} s,
            U_w = {U_w} V,
            p_0 = {p0} Torr,
            d = {gap_length} m,
            N_0 = {N0} m^-3,
            T_gas = {Tgas} K
            """
        )
        log_str = log_str.rstrip().replace("\n", "\t ")
        log_str = f"Simulation conditions:\n{log_str}\n"
    elif log_type == "matrices":
        gain, loss, power = args
        log_str = dedent(
            f"""\
            Gain matrix:
            {numpy_2d_array_to_str(gain)}

            Loss matrix:
            {numpy_2d_array_to_str(loss)}

            Power matrix:
            {numpy_2d_array_to_str(power)}
            """
        )
    elif log_type == "initial time":
        log_str = f"Time:\n{args[0]}"
    elif log_type == "time":
        log_str = str(args[0])
    elif log_type == "mesh":
        from ..mesh import mesh_info

        log_str = mesh_info(args[0])
    else:
        raise ValueError(
            f"log type '{log_type}' not recognised; options are 'properties', "
            "'conditions', 'matrices', 'initial time', 'time', 'mesh'"
        )

    with open(log_file_name, "a") as f:
        f.write(log_str)
        f.write("\n")
        f.flush()
