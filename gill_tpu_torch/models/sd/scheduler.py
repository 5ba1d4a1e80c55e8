"""Diffusion schedulers (counterpart of gill_tpu/models/sd/scheduler.py):
PNDM/PLMS, SD v1.5's default (diffusers PNDMScheduler with
skip_prk_steps=True, scaled_linear betas 0.00085 -> 0.012 over 1000 steps,
steps_offset=1, set_alpha_to_one=False), DDIM, and DPM-Solver++ 2M.

The PLMS state holds the 4-slot ring of past model outputs (`ets`, newest
first), how many are filled, the step counter and the sample saved at step
0 for the second-order warm-up. gill_tpu threads the same state through a
lax.scan as fixed-shape arrays; here it is a dict updated step by step.
The scheduler math runs in fp32. A multistep solver on a non-uniform grid
(DPM-Solver++) has `prev_timesteps`, and the pipeline then passes each
step the next timestep.
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


class DDIMScheduler:
    """Deterministic DDIM (eta = 0) on the uniform grid of PNDM without the
    repeated warm-up step."""

    def __init__(self, cfg: SchedulerConfig = SchedulerConfig()):
        self.cfg = cfg
        self.acp = alphas_cumprod(cfg)
        self.final_alpha = (torch.tensor(1.0) if cfg.set_alpha_to_one
                            else self.acp[0])
        self.init_noise_sigma = 1.0

    def timesteps(self, num_inference_steps: int) -> Tuple[List[int], int]:
        ratio = self.cfg.num_train_timesteps // num_inference_steps
        ts = [i * ratio + self.cfg.steps_offset
              for i in range(num_inference_steps)]
        return ts[::-1], ratio

    def init_state(self, sample):
        return {}

    def step(self, state, model_output, timestep: int, sample,
             step_ratio: int):
        prev_t = timestep - step_ratio
        a_t = self.acp[timestep]
        a_prev = self.acp[prev_t] if prev_t >= 0 else self.final_alpha
        dev = sample.device
        s, eps = sample.float(), model_output.float()
        x0 = (s - ((1.0 - a_t) ** 0.5).to(dev) * eps) / (a_t ** 0.5).to(dev)
        prev = ((a_prev ** 0.5).to(dev) * x0
                + ((1.0 - a_prev) ** 0.5).to(dev) * eps)
        return prev.to(sample.dtype), state


class DPMSolverPPScheduler:
    """DPM-Solver++ 2M (diffusers DPMSolverMultistepScheduler with
    algorithm_type='dpmsolver++', solver_order=2, epsilon prediction,
    lower_order_final): about 20-25 steps reach 50-step PNDM quality. The
    state is the previous x0 prediction, the last log-SNR step and the step
    index."""

    def __init__(self, cfg: SchedulerConfig = SchedulerConfig()):
        self.cfg = cfg
        self.acp = alphas_cumprod(cfg)
        self.init_noise_sigma = 1.0
        self._n = 1000

    def timesteps(self, num_inference_steps: int) -> Tuple[List[int], int]:
        """diffusers: linspace(0, T-1, n+1).round()[::-1][:-1], in fp32."""
        ts = torch.linspace(0, self.cfg.num_train_timesteps - 1,
                            num_inference_steps + 1, dtype=torch.float32)
        self._n = num_inference_steps
        return [int(x) for x in torch.round(ts).flip(0)[:-1]], 0

    def prev_timesteps(self, ts: List[int]) -> List[int]:
        return list(ts[1:]) + [0]

    def init_state(self, sample):
        return {"m1": torch.zeros(sample.shape, dtype=torch.float32,
                                  device=sample.device),
                "h_last": torch.tensor(0.0), "i": 0}

    def _coeffs(self, t: int):
        a = torch.sqrt(self.acp[t])
        s = torch.sqrt(1.0 - self.acp[t])
        return a, s, torch.log(a) - torch.log(s)

    def step(self, state, model_output, timestep: int, sample,
             step_ratio: int, prev_timestep=None):
        if prev_timestep is None:
            raise ValueError("DPM-Solver++ needs prev_timestep (the "
                             "pipeline passes it)")
        a_t, s_t, lam_t = self._coeffs(int(timestep))
        a_p, s_p, lam_p = self._coeffs(int(prev_timestep))
        h = lam_p - lam_t
        dev = sample.device
        x = sample.float()
        x0 = (x - s_t.to(dev) * model_output.float()) / a_t.to(dev)
        # second order with the previous x0; the first step (and the final
        # one when n < 15, diffusers lower_order_final) is first order
        use_first = state["i"] == 0 or (self._n < 15
                                        and state["i"] == self._n - 1)
        if use_first:
            d = x0
        else:
            r = state["h_last"] / torch.where(h == 0, 1.0, h)
            c = 1.0 / (2.0 * torch.where(r == 0, 1.0, r))
            d = (1.0 + c).to(dev) * x0 - c.to(dev) * state["m1"]
        prev = (s_p / s_t).to(dev) * x - (a_p * torch.expm1(-h)).to(dev) * d
        return prev.to(sample.dtype), {"m1": x0, "h_last": h,
                                       "i": state["i"] + 1}


SAMPLERS = {"pndm": PNDMScheduler, "dpm++": DPMSolverPPScheduler}
