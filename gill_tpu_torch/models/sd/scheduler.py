"""PNDM/PLMS scheduler, SD v1.5's default (counterpart of the PNDMScheduler
in gill_tpu/models/sd/scheduler.py: diffusers PNDMScheduler with
skip_prk_steps=True, scaled_linear betas 0.00085 -> 0.012 over 1000 steps,
steps_offset=1, set_alpha_to_one=False).

The state holds the 4-slot ring of past model outputs (`ets`, newest
first), how many are filled, the step counter and the sample saved at step
0 for the second-order warm-up. gill_tpu threads the same state through a
lax.scan as fixed-shape arrays; here it is a dict updated step by step.
The scheduler math runs in fp32. DDIM and DPM-Solver++ are not ported.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from gill_tpu_torch.config import SchedulerConfig


def alphas_cumprod(cfg: SchedulerConfig) -> torch.Tensor:
    if cfg.beta_schedule == "scaled_linear":
        betas = torch.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                               cfg.num_train_timesteps,
                               dtype=torch.float32) ** 2
    elif cfg.beta_schedule == "linear":
        betas = torch.linspace(cfg.beta_start, cfg.beta_end,
                               cfg.num_train_timesteps, dtype=torch.float32)
    else:
        raise NotImplementedError(cfg.beta_schedule)
    return torch.cumprod(1.0 - betas, dim=0)


class PNDMScheduler:
    def __init__(self, cfg: SchedulerConfig = SchedulerConfig()):
        self.cfg = cfg
        self.acp = alphas_cumprod(cfg)
        self.final_alpha = (torch.tensor(1.0) if cfg.set_alpha_to_one
                            else self.acp[0])
        self.init_noise_sigma = 1.0

    def timesteps(self, num_inference_steps: int) -> Tuple[List[int], int]:
        """(timesteps with the second entry repeated once for the warm-up,
        step_ratio): num_inference_steps + 1 model evaluations."""
        ratio = self.cfg.num_train_timesteps // num_inference_steps
        ts = [i * ratio + self.cfg.steps_offset
              for i in range(num_inference_steps)]
        plms = ts[:-1] + ts[-2:-1] + ts[-1:]
        return plms[::-1], ratio

    def init_state(self, sample):
        return {"ets": [], "counter": 0, "cur_sample": torch.zeros_like(sample)}

    def _get_prev_sample(self, sample, t: int, prev_t: int, eps):
        a_t = self.acp[t]
        a_prev = self.acp[prev_t] if prev_t >= 0 else self.final_alpha
        b_t, b_prev = 1.0 - a_t, 1.0 - a_prev
        sample_coeff = (a_prev / a_t) ** 0.5
        denom = a_t * b_prev ** 0.5 + (a_t * b_t * a_prev) ** 0.5
        coeff = (a_prev - a_t) / denom
        dev = sample.device
        prev = (sample_coeff.to(dev) * sample.float()
                - coeff.to(dev) * eps.float())
        return prev.to(sample.dtype)

    def step(self, state, model_output, timestep: int, sample,
             step_ratio: int):
        """One PLMS step. Returns (prev_sample, new_state)."""
        counter, ets = state["counter"], state["ets"]
        is_c1 = counter == 1
        prev_t = timestep if is_c1 else timestep - step_ratio
        t_eff = timestep + step_ratio if is_c1 else timestep
        if not is_c1:
            ets = [model_output] + ets[:3]
        mo = model_output.float()
        e = [x.float() for x in ets]
        if counter == 0:
            blended = mo
        elif counter == 1:
            blended = (mo + e[0]) / 2.0
        elif len(ets) == 2:
            blended = (3.0 * e[0] - e[1]) / 2.0
        elif len(ets) == 3:
            blended = (23.0 * e[0] - 16.0 * e[1] + 5.0 * e[2]) / 12.0
        else:
            blended = (55.0 * e[0] - 59.0 * e[1] + 37.0 * e[2]
                       - 9.0 * e[3]) / 24.0
        blended = blended.to(model_output.dtype)
        sample_eff = state["cur_sample"] if is_c1 else sample
        new_cur = sample if counter == 0 else state["cur_sample"]
        prev = self._get_prev_sample(sample_eff, t_eff, prev_t, blended)
        return prev, {"ets": ets, "counter": counter + 1,
                      "cur_sample": new_cur}
