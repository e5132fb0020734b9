from rust_robotics_tpu_torch.control.mission import (  # noqa: F401
    Action,
    Condition,
    Selector,
    Sequence,
    StateMachine,
    Status,
    make_waypoint_mission,
)
