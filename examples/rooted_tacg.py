"""Rooted tree with user-supplied tip CLVs (partial likelihoods).

Mirror of /root/reference/examples/rooted-tacg/rooted-tacg.c: tips are
set from explicit conditional-probability vectors via set_tip_clv
instead of character sequences.
"""
import _common  # noqa: F401
import numpy as np

import libpll2_jax as pll

SITES, RATES, STATES = 4, 4, 4
partition = pll.Partition(tips=3, clv_buffers=2, states=STATES,
                          sites=SITES, rate_matrices=1, prob_matrices=4,
                          rate_cats=RATES, scale_buffers=2)

partition.set_frequencies(0, [0.25, 0.25, 0.25, 0.25])
partition.set_subst_params(0, [1, 1, 1, 1, 1, 1])
partition.set_category_rates(pll.compute_gamma_cats(1.0, RATES))

# explicit tip CLVs: [sites, rate_cats, states]; e.g. "T A C G" observed
def onehot(idx):
    v = np.zeros(STATES)
    v[idx] = 1.0
    return v

tacg = np.stack([onehot(3), onehot(0), onehot(1), onehot(2)])  # T A C G
ambig = tacg.copy()
ambig[0] = onehot(3) + onehot(1)                               # Y = C|T
for tip, base in enumerate((tacg, tacg, ambig)):
    clv = np.repeat(base[:, None, :], RATES, axis=1)
    partition.set_tip_clv(tip, clv)

partition.update_prob_matrices([0] * RATES, [0, 1, 2, 3],
                               [0.2, 0.4, 0.3, 0.5])

NONE = pll.SCALE_BUFFER_NONE
operations = [
    pll.Operation(3, 0, 1, 0, 1, 0, NONE, NONE),
    pll.Operation(4, 3, 2, 2, 3, 1, 0, NONE),
]
partition.update_partials(operations)
logl = partition.compute_root_loglikelihood(4, 1, [0] * RATES)
print(f"Log-L (tip CLVs): {logl:f}")
