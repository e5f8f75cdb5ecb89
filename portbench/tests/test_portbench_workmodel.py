"""The frozen work model and peaks equal the port's functions today, so
that a change to the program cannot move the yardstick unseen."""

import itertools

from portbench import workmodel


def test_frozen_work_model_matches_the_program():
    from aiyagari_hark_tpu_torch.obs import profile
    from aiyagari_hark_tpu_torch.utils import timing

    for s, lanes, N, A, D, steps in itertools.product(
            (4, 8), (1, 24), (7, 15), (32, 1000), (500, 1000),
            (0.0, 1234.0)):
        assert workmodel.egm_work(s, lanes, N, A, steps) == \
            profile.egm_work(s, lanes, N, A, steps)
        assert workmodel.egm_work(s, lanes, N, A, steps, A + 3) == \
            profile.egm_work(s, lanes, N, A, steps, A + 3)
        assert workmodel.dist_work(s, lanes, N, D, steps) == \
            profile.dist_work(s, lanes, N, D, steps)
        for dense in (False, True):
            assert workmodel.model_flops(steps, 2 * steps, A, N, D,
                                         dense) == \
                timing.model_flops(steps, 2 * steps, A, N, D, dense)
    assert workmodel.PEAK_FLOPS == timing.H100_SXM_PEAK_FLOPS
    assert workmodel.PEAK_BYTES_PER_S == timing.H100_SXM_BYTES_PER_S


def test_supply_work_is_the_split_pair():
    b, o = workmodel.supply_work(8, 7, 32, 500, 31, 1000, 20000)
    eb, eo = workmodel.egm_work(8, 31, 7, 32, 1000)
    db, do = workmodel.dist_work(8, 31, 7, 500, 20000)
    assert b == eb + db and o == eo + do
