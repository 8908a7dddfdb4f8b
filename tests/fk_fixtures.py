"""Trees and configurations on which the FK kernel (`kernels.fk`) is held
against the plain FK: tests/test_torch_fk_kernel.py, and tools/fk_check.py
on the card."""

import dataclasses

import numpy as np
import torch

from loik_tpu_torch.model import builders
from loik_tpu_torch.model import tree as mtree

# every joint type, four mimic pairs among them (their member types drawn)
EVERY = (mtree.REVOLUTE, mtree.PRISMATIC, mtree.SPHERICAL, mtree.REVOLUTE_UNBOUNDED,
         mtree.TRANSLATION, mtree.PLANAR, mtree.UNIVERSAL, mtree.HELICAL,
         mtree.SPHERICAL_ZYX) + (mtree.MIMIC_PAIR,) * 4


def zoo(seed, dtype=torch.float64, device="cpu"):
    """A free-flyer root and one joint of every other type on random
    placements and axes (`builders.random_tree`)."""
    tree = builders.random_tree(np.random.default_rng(seed), 1 + len(EVERY),
                                floating_base=True, force_types=EVERY,
                                name=f"zoo{seed}", device=device)
    return tree.to(dtype=dtype)


def per_problem(tree, B, seed=0):
    """``tree`` with placements and axes given per problem (batched
    geometry, as the mixed super-batch's chain), moved a little from
    problem to problem."""
    gen = torch.Generator(device=tree.device).manual_seed(seed)

    def leaf(x):
        noise = 1e-2 * torch.randn((x.shape[0], B) + x.shape[1:], generator=gen,
                                   dtype=torch.float64, device=x.device)
        return (x[:, None].double() + noise).to(x.dtype)

    return dataclasses.replace(tree, placement_R=leaf(tree.placement_R),
                               placement_p=leaf(tree.placement_p), axis=leaf(tree.axis))


def plain(tree, q):
    """The plain FK's liMi in the kernel's layout."""
    lR, lp, _, _ = tree.fwd_kinematics(q)
    return lR.movedim(0, -1), lp.movedim(0, -1)


def configurations(tree, B, seed=0):
    gen = torch.Generator(device=tree.device).manual_seed(seed)
    return tree.random_configuration((B,), generator=gen)
