// Lifecycle state machine — parity with the reference's ROS 2 managed-node
// transitions (perception_node.cpp:409-539): UNCONFIGURED -> configure ->
// INACTIVE -> activate -> ACTIVE -> deactivate -> INACTIVE -> cleanup ->
// UNCONFIGURED; shutdown from anywhere -> FINALIZED.
#pragma once

#include <functional>
#include <stdexcept>
#include <string>

namespace unina {

enum class State { kUnconfigured, kInactive, kActive, kFinalized };

inline const char* state_name(State s) {
  switch (s) {
    case State::kUnconfigured: return "unconfigured";
    case State::kInactive: return "inactive";
    case State::kActive: return "active";
    case State::kFinalized: return "finalized";
  }
  return "?";
}

class Lifecycle {
 public:
  using Hook = std::function<void()>;

  void on_configure(Hook h) { configure_ = std::move(h); }
  void on_activate(Hook h) { activate_ = std::move(h); }
  void on_deactivate(Hook h) { deactivate_ = std::move(h); }
  void on_cleanup(Hook h) { cleanup_ = std::move(h); }

  State state() const { return state_; }

  void configure() {
    expect(State::kUnconfigured, "configure");
    if (configure_) configure_();
    state_ = State::kInactive;
  }
  void activate() {
    expect(State::kInactive, "activate");
    if (activate_) activate_();
    state_ = State::kActive;
  }
  void deactivate() {
    expect(State::kActive, "deactivate");
    if (deactivate_) deactivate_();
    state_ = State::kInactive;
  }
  void cleanup() {
    expect(State::kInactive, "cleanup");
    if (cleanup_) cleanup_();
    state_ = State::kUnconfigured;
  }
  void shutdown() {
    if (state_ == State::kActive && deactivate_) deactivate_();
    if (state_ != State::kUnconfigured && cleanup_) cleanup_();
    state_ = State::kFinalized;
  }

 private:
  void expect(State s, const char* what) {
    if (state_ != s)
      throw std::runtime_error(std::string(what) + "() invalid in state " +
                               state_name(state_));
  }
  State state_ = State::kUnconfigured;
  Hook configure_, activate_, deactivate_, cleanup_;
};

}  // namespace unina
